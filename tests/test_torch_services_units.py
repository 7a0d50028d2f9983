"""The daemons' host logic in the port (``ceph_tpu_torch/services``)
against ``ceph_tpu``'s, with no cluster: the same seeded inputs go
through both packages' classes and every output must be equal.

- ``recovery``: ``HelperLedger`` and ``ReservationBook`` on one op
  schedule;
- ``quorum``: election, leases, accept/commit and probing of one
  ``Quorum`` against scripted peers (acks, nacks, unreachable peers);
- ``heartbeat``: the peer set of every OSD of a map and the overdue
  peers under the effective grace (``grace + 4 x ewma``);
- ``map_follower``: the cached ``pg_up_acting`` of every PG, before and
  after an incremental is applied copy-and-swap;
- ``striper``: extent maps; ``image``: header bytes and their decode.

Integers and bytes throughout: no tolerance.
"""

import inspect
import json
import random
import threading
import types

import numpy as np
import pytest
import torch

import ceph_tpu.common.config as r_config
import ceph_tpu.common.perf_counters as r_perf
import ceph_tpu.crush.wrapper as r_wrapper
import ceph_tpu.osdmap.incremental as r_inc
import ceph_tpu.osdmap.osdmap as r_osdmap
import ceph_tpu.services.heartbeat as r_heartbeat
import ceph_tpu.services.image as r_image
import ceph_tpu.services.map_follower as r_follower
import ceph_tpu.services.quorum as r_quorum
import ceph_tpu.services.recovery as r_recovery
import ceph_tpu.services.striper as r_striper
import ceph_tpu_torch.common.config as p_config
import ceph_tpu_torch.common.perf_counters as p_perf
import ceph_tpu_torch.crush.wrapper as p_wrapper
import ceph_tpu_torch.osdmap.incremental as p_inc
import ceph_tpu_torch.osdmap.osdmap as p_osdmap
import ceph_tpu_torch.services.heartbeat as p_heartbeat
import ceph_tpu_torch.services.image as p_image
import ceph_tpu_torch.services.map_follower as p_follower
import ceph_tpu_torch.services.quorum as p_quorum
import ceph_tpu_torch.services.recovery as p_recovery
import ceph_tpu_torch.services.striper as p_striper
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

REF = types.SimpleNamespace(
    config=r_config, perf=r_perf, wrapper=r_wrapper, inc=r_inc,
    osdmap=r_osdmap, heartbeat=r_heartbeat, image=r_image,
    follower=r_follower, quorum=r_quorum, recovery=r_recovery,
    striper=r_striper)
PORT = types.SimpleNamespace(
    config=p_config, perf=p_perf, wrapper=p_wrapper, inc=p_inc,
    osdmap=p_osdmap, heartbeat=p_heartbeat, image=p_image,
    follower=p_follower, quorum=p_quorum, recovery=p_recovery,
    striper=p_striper)
SEEDS = (13, 14, 15)


def both(fn, *args):
    """``fn(pkg, *args)`` for ``ceph_tpu`` and the port."""
    return fn(REF, *args), fn(PORT, *args)


# -- recovery: HelperLedger and ReservationBook ---------------------------

def _recovery_trace(pkg, seed):
    rng = np.random.default_rng(seed)
    led = pkg.recovery.HelperLedger()
    book = pkg.recovery.ReservationBook(int(rng.integers(1, 5)))
    keys = [(1, ps, f"obj{ps}") for ps in range(4)]
    out = []
    for _ in range(300):
        op = int(rng.integers(0, 8))
        osd = int(rng.integers(0, 6))
        key = keys[int(rng.integers(0, len(keys)))]
        if op == 0:
            led.start(osd)
        elif op == 1:
            led.finish(osd)
        elif op == 2:
            led.note_load(osd, float(rng.integers(0, 50)) / 4)
        elif op == 3:
            led.exclude(key, osd)
            out.append(("excluded", key, sorted(led.excluded(key))))
        elif op == 4:
            out.append(("try_acquire", book.try_acquire(), book.held))
        elif op == 5:
            book.release()
            out.append(("release", book.held))
        out.append(("load", osd, led.load(osd)))
    dump = led.dump()
    out.append(("dump", dump["inflight"], dump["remote_load"],
                dump["excluded"], book.held, book.slots))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_recovery_books_equal(seed):
    ref, port = both(_recovery_trace, seed)
    assert port == ref


def test_exclusion_ttl_doubles_to_its_cap():
    """A repeated exclusion doubles its time to live up to the cap in
    both packages (the TTLs, not the clock, are compared)."""
    def ttls(pkg):
        led = pkg.recovery.HelperLedger()
        seen = []
        for _ in range(8):
            led.exclude(("k",), 3)
            seen.append(led._excluded[("k",)][3][1])
        return seen, pkg.recovery.EXCLUDE_BASE_S, pkg.recovery.EXCLUDE_CAP_S

    ref, port = both(ttls)
    assert port == ref
    assert port[0][-1] == port[2]


# -- quorum: elections, leases, replication --------------------------------

class _Log:
    def dout(self, *_a):
        pass

    derr = dout


class _Msgr:
    """Peers answering from a seeded script: an ack, a nack or no
    answer (OSError) per call, by message type."""

    def __init__(self, rng, lc_of):
        self.rng = rng
        self.lc_of = lc_of
        self.handlers = {}
        self.sent = []

    def register(self, t, h, ordered=False, control=False):
        self.handlers[t] = h

    def send(self, addr, msg):
        self.sent.append((tuple(addr), dict(msg)))

    def call(self, addr, msg, timeout=None):
        r = self.rng
        if r.random() < 0.2:
            raise OSError("peer unreachable")
        t = msg["type"]
        e = int(msg.get("e", 0))
        if t == "mon_propose":
            ack = r.random() < 0.6
            rep = {"ack": ack, "epoch": e + int(r.integers(-1, 2)),
                   "last_committed": int(r.integers(0, 3)) + self.lc_of()}
            if ack and r.random() < 0.3:
                rep["uncommitted"] = {"v": self.lc_of() + 1,
                                      "e": int(r.integers(1, 5)),
                                      "entry": {"x": int(r.integers(9))}}
            return rep
        if t == "mon_probe":
            return {"leader": (None if r.random() < 0.5
                               else int(r.integers(0, 3))),
                    "epoch": int(r.integers(0, 8)),
                    "last_committed": self.lc_of()}
        if t == "mon_fetch":
            return {"entries": [{"v": v, "entry": {"v": v}}
                                for v in range(int(msg["from_v"]) + 1,
                                               int(msg["to_v"]) + 1)]}
        if t == "mon_accept":
            return {"ack": r.random() < 0.7}
        return {"ok": r.random() < 0.7}


class _Mon:
    """What ``Quorum`` asks of its monitor."""

    def __init__(self, rng):
        self.lc = 0
        self.msgr = _Msgr(rng, lambda: self.lc)
        self.log = _Log()
        self.stored = []
        self.leader_calls = []

    def last_committed(self):
        return self.lc

    def committed_entries(self, frm, to):
        return [{"v": v, "entry": {"v": v}}
                for v in range(frm + 1, min(to, self.lc) + 1)]

    def apply_committed(self, v, entry):
        self.lc = v

    def store_quorum_state(self, st):
        self.stored.append(json.loads(json.dumps(st)))

    def load_quorum_state(self):
        return {}

    def on_leader(self, entry):
        self.leader_calls.append(entry)


def _quorum_state(q):
    return (q.state, q.election_epoch, q.leader_rank, q.promised_rank,
            json.dumps(q.uncommitted, sort_keys=True), q.is_leader(),
            q.leader_addr())


def _quorum_trace(pkg, seed, rank):
    rng = np.random.default_rng(seed)
    mon = _Mon(np.random.default_rng(seed + 1000))
    addrs = [("127.0.0.1", 6789 + r) for r in range(3)]
    q = pkg.quorum.Quorum(mon, rank, addrs, lease=1.0,
                          election_timeout=1.0)
    out = [_quorum_state(q)]
    for _ in range(120):
        op = int(rng.integers(0, 10))
        e = q.election_epoch + int(rng.integers(-1, 3))
        who = int(rng.integers(0, 3))
        if op == 0:
            q._start_election()
            rep = None
        elif op == 1:
            rep = q._h_propose({"e": e, "rank": who})
        elif op == 2:
            rep = q._h_victory({"e": e, "leader": who})
        elif op == 3:
            # a lease never names a newer commit here: that would start
            # a fetch thread
            rep = q._h_lease({"e": e, "leader": who,
                              "last_committed": mon.lc})
        elif op == 4:
            rep = q._h_accept({"e": e, "v": mon.lc + int(rng.integers(
                0, 2)), "entry": {"x": int(rng.integers(9))}})
        elif op == 5:
            u = q.uncommitted
            v = int(u["v"]) if u and rng.random() < 0.7 else mon.lc + 1
            rep = q._h_commit({"e": e, "v": v})
        elif op == 6:
            rep = q.replicate(mon.lc + 1, {"x": int(rng.integers(9))})
            if rep:
                mon.lc += 1
        elif op == 7:
            q._send_leases()
            rep = None
        elif op == 8:
            rep = q._probe() if q.state == r_quorum.PROBING else None
        else:
            q.abdicate()
            rep = None
        out.append((op, json.dumps(rep, sort_keys=True),
                    _quorum_state(q)))
    out.append(("stored", mon.stored, "leader", mon.leader_calls,
                "sent", mon.msgr.sent, "lc", mon.lc))
    out.append(("pick", q._pick_uncommitted(
        [{"v": 3, "e": 1}, {"v": 3, "e": 4}, {"v": 5, "e": 9},
         {"v": 3, "e": 2}], 2)))
    return out


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("seed", SEEDS)
def test_quorum_election_and_leases_equal(seed, rank):
    ref, port = both(_quorum_trace, seed, rank)
    assert port == ref
    states = {row[2][0] for row in ref[1:-2]}
    assert len(states) > 1   # the schedule moved the state machine


# -- heartbeat: peer set and effective grace -------------------------------

def make_map(pkg, seed, n=9):
    """A map of ``n`` OSDs on ``n`` hosts with a replicated and an EC
    pool, a few OSDs down or out, upmap items and a pg_temp, from
    ``seed``; built in ``ceph_tpu`` and handed to ``pkg`` as JSON."""
    rng = np.random.default_rng(seed)
    w = r_wrapper.CrushWrapper()
    for d in range(n):
        w.insert_item(d, 0x10000, f"osd.{d}",
                      {"host": f"host{d}", "root": "default"})
    rep = w.add_simple_rule("replicated_rule", "default", "host", "",
                            "firstn")
    ec = w.add_simple_rule("ec_rule", "default", "host", "", "indep",
                           rule_type=3)
    m = r_osdmap.OSDMap(w.crush)
    for d in range(n):
        m.add_osd(d)
    m.pools[1] = r_osdmap.PgPool(size=3, pg_num=16, crush_rule=rep)
    m.pools[2] = r_osdmap.PgPool(
        pool_type=r_osdmap.POOL_TYPE_ERASURE, size=6, min_size=4,
        pg_num=8, crush_rule=ec, erasure_code_profile="p")
    for d in rng.choice(n, 2, replace=False):
        m.osd_state[int(d)] = r_osdmap.OSD_EXISTS   # down
    m.osd_weight[int(rng.integers(0, n))] = 0       # out
    for ps in rng.choice(16, 3, replace=False):
        a, b = (int(x) for x in rng.choice(n, 2, replace=False))
        m.pg_upmap_items[(1, int(ps))] = [(a, b)]
    m.pg_temp[(1, int(rng.integers(0, 16)))] = [
        int(x) for x in rng.choice(n, 3, replace=False)]
    return pkg.osdmap.OSDMap.from_dict(json.loads(json.dumps(m.to_dict())))


class _Follower:
    """A map follower with nothing around it (the fields ``MapFollower``
    reads)."""

    def __init__(self, pkg, m):
        self._lock = threading.RLock()
        self.map = m
        self.epoch = m.epoch
        self.osd_addrs = {}
        self.ec_profiles = {}
        self.installs = 0

    def _post_map_install(self):
        self.installs += 1


def follower(pkg, m):
    cls = type("F", (_Follower, pkg.follower.MapFollower), {})
    return cls(pkg, m)


class _Svc:
    """What ``HeartbeatPlane`` asks of its OSD."""

    def __init__(self, pkg, osd, m, conf):
        self.id = osd
        self.log = _Log()
        self.ctx = types.SimpleNamespace(
            conf=conf, perf=pkg.perf.PerfCountersCollection())
        self.msgr = _Msgr(np.random.default_rng(0), lambda: 0)
        self.addr = ("127.0.0.1", 7000 + osd)
        self.osd_addrs = {o: ("127.0.0.1", 7000 + o)
                          for o in range(m.max_osd)}
        self.reports = []
        self._f = follower(pkg, m)
        self._lock = self._f._lock
        self.map = m

    def pg_up_acting(self, pool_id, ps):
        return self._f.pg_up_acting(pool_id, ps)

    def mon_send(self, msg):
        self.reports.append((msg["osd"], msg["frm_osd"]))


def _heartbeat_trace(pkg, seed):
    m = make_map(pkg, seed)
    conf = pkg.config.Config()
    conf.set("osd_heartbeat_min_peers", 4)
    rng = np.random.default_rng(seed)
    out = []
    for osd in range(m.max_osd):
        svc = _Svc(pkg, osd, m, conf)
        hb = pkg.heartbeat.HeartbeatPlane(svc)
        hb.update_peers()
        peers = sorted(hb._peers)
        # each peer's last ack and latency EWMA, well away from its
        # effective grace, so the host's clock cannot move a verdict
        for o in peers:
            p = hb._peers[o]
            p.ewma = float(rng.integers(0, 5)) / 10
            eff = hb.grace + pkg.heartbeat.GRACE_LAT_FACTOR * p.ewma
            p.last_ack -= eff + (1.0 if rng.random() < 0.5 else -1.0)
        hb._tick()
        pinged = sorted(a[1] - 7000 for a, msg in svc.msgr.sent
                        if msg["type"] == "osd_ping")
        out.append((osd, peers, pinged, sorted(svc.reports)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_heartbeat_peers_and_grace_equal(seed):
    ref, port = both(_heartbeat_trace, seed)
    assert port == ref
    assert any(reports for *_x, reports in ref)


# -- map_follower: cached placement across an incremental ------------------

def _follower_trace(pkg, seed):
    m = make_map(pkg, seed)
    f = follower(pkg, m)
    pc = pkg.follower._pc
    before = dict(pc.dump())
    out = []
    for rnd in range(2):
        for pid, pool in sorted(m.pools.items()):
            for ps in range(pool.pg_num):
                out.append((rnd, pid, ps, f.pg_up_acting(pid, ps)))
    # an incremental: an OSD back up, another out, new upmap items
    new = pkg.osdmap.OSDMap.from_dict(json.loads(json.dumps(m.to_dict())))
    down = [o for o in range(new.max_osd) if not new.is_up(o)]
    new.osd_state[down[0]] |= pkg.osdmap.OSD_UP
    new.osd_weight[int(seed) % new.max_osd] = 0
    new.pg_upmap_items[(1, 0)] = [(0, new.max_osd - 1)]
    inc = pkg.inc.diff_maps(m, new)
    inc.epoch = f.epoch + 1
    old = f.map
    assert f._apply_one_inc(inc)
    assert f.map is not old and f.epoch == inc.epoch
    assert not f._apply_one_inc(inc)   # not contiguous any more
    for pid, pool in sorted(f.map.pools.items()):
        for ps in range(pool.pg_num):
            out.append(("after", pid, ps, f.pg_up_acting(pid, ps),
                        new.pg_to_up_acting_osds(pid, ps)))
    after = pc.dump()
    out.append(("lookups", after["pg_lookups"] - before["pg_lookups"],
                "hits", after["cache_hits"] - before["cache_hits"]))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_follower_cached_placement_equal(seed):
    ref, port = both(_follower_trace, seed)
    assert port == ref
    for row in port:
        if row[0] == "after":
            assert row[3] == row[4]   # the swapped map's placement


# -- striper extents and image headers ------------------------------------

def _layouts(seed):
    rng = random.Random(seed)
    out = []
    for _ in range(40):
        unit = rng.choice([512, 4096, 65536])
        count = rng.choice([1, 2, 3, 4, 8])
        osize = unit * rng.choice([1, 2, 4, 16])
        off = rng.randrange(0, 4 * osize * count)
        ln = rng.randrange(0, 3 * osize * count)
        out.append((unit, count, osize, off, ln))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_striper_extent_maps_equal(seed):
    def maps(pkg):
        return [pkg.striper.Striper(None, stripe_unit=u, stripe_count=c,
                                    object_size=o).extent_map(off, ln)
                for u, c, o, off, ln in _layouts(seed)]

    ref, port = both(maps)
    assert port == ref
    for (_u, _c, _o, off, ln), ext in zip(_layouts(seed), port):
        assert sum(run for *_x, run in ext) == ln
        assert [lo for _n, _oo, lo, _r in ext] == sorted(
            lo for _n, _oo, lo, _r in ext)
        assert not ext or ext[0][2] == off


def test_striper_rejects_bad_layouts():
    for pkg in (REF, PORT):
        with pytest.raises(ValueError):
            pkg.striper.Striper(None, stripe_unit=0)
        with pytest.raises(ValueError):
            pkg.striper.Striper(None, stripe_unit=4096, object_size=6000)


@pytest.mark.parametrize("seed", SEEDS)
def test_image_headers_equal(seed):
    rng = random.Random(seed)
    header = {"size": rng.randrange(1 << 30), "stripe_unit": 4096,
              "stripe_count": rng.choice([1, 4]),
              "object_size": 1 << rng.choice([16, 22]),
              "snaps": [{"name": f"s{i}", "size": rng.randrange(1 << 20),
                         "protected": rng.random() < 0.5}
                        for i in range(rng.randrange(3))],
              "parent": (None if rng.random() < 0.5 else
                         {"pool": 2, "name": "base", "snap": "s0",
                          "overlap": rng.randrange(1 << 20)}),
              "children": [f"c{i}" for i in range(rng.randrange(3))]}
    ref, port = both(lambda pkg: pkg.image.encode_header(header))
    assert port == ref
    assert p_image.decode_header(ref) == r_image.decode_header(port) \
        == header
    with pytest.raises(p_image.encoding.MalformedInput):
        p_image.decode_header(p_image.encoding.encode([1, 2], 1, 1)
                              .encode())


# -- the daemons' device ----------------------------------------------------

def test_daemons_run_on_the_card_unless_told():
    """``OSDService``, ``Client``, ``MgrDaemon`` and ``MiniCluster`` take
    ``device="cuda"`` by default; without a card their EC codes and the
    balancer's sweep raise instead of carrying on on the CPU."""
    from ceph_tpu_torch.mgr.balancer_module import BalancerModule
    from ceph_tpu_torch.mgr.daemon import MgrDaemon
    from ceph_tpu_torch.services.client import Client
    from ceph_tpu_torch.services.cluster import MiniCluster
    from ceph_tpu_torch.services.osd_service import OSDService

    for cls in (OSDService, Client, MgrDaemon, MiniCluster):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    pool = p_osdmap.PgPool(pool_type=p_osdmap.POOL_TYPE_ERASURE, size=6,
                           pg_num=8, erasure_code_profile="p")
    for cls in (OSDService, Client):
        me = types.SimpleNamespace(
            _codes={}, device="cuda",
            ec_profiles={"p": {"plugin": "jerasure", "k": "4", "m": "2"}})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls._code_for(me, pool)
        me.device = "cpu"
        assert cls._code_for(me, pool).get_chunk_count() == 6
        # engine=native asks for no card
        me = types.SimpleNamespace(_codes={}, device="cuda", ec_profiles={
            "p": {"plugin": "jerasure", "k": "4", "m": "2",
                  "engine": "native"}})
        assert cls._code_for(me, pool).get_chunk_count() == 6
    m = make_map(PORT, SEEDS[0])
    mgr = types.SimpleNamespace(
        device="cuda", pc=p_perf.PerfCountersCollection().create("mgr.t"),
        log=_Log(), _lock=threading.RLock(), map=m, epoch=m.epoch,
        ctx=types.SimpleNamespace(conf=p_config.Config()))
    mgr.pc.add_u64_counter("balancer_sweep_launches")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BalancerModule(mgr).command({"argv": ["eval"]})
    mgr.device = "cpu"
    assert BalancerModule(mgr).command({"argv": ["eval"]})[
        "mapped_pgs"] == 24
