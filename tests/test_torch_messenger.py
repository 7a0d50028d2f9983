"""The port's messenger, frame codec, auth and bufpool against
``ceph_tpu``'s.

Frames are compared byte for byte and decoded across the packages;
live exchanges run in both directions between a port messenger and a
``ceph_tpu`` messenger (lossless and lossy, signed), through a dropped
connection replayed with nothing lost and nothing duplicated, and
through the port's per-type throttles.  The messengers of the live
exchanges are shared by the file (``links``); the tests that break a
connection build their own pair.
"""

import json
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from ceph_tpu.common import bufpool as j_bufpool
from ceph_tpu.common import perf_counters as j_pc
from ceph_tpu.common.encoding import MalformedInput as JMalformed
from ceph_tpu.msg import auth as j_auth
from ceph_tpu.msg import messenger as j_msgr
from ceph_tpu_torch.common import bufpool as p_bufpool
from ceph_tpu_torch.common import perf_counters as p_pc
from ceph_tpu_torch.common.encoding import MalformedInput as PMalformed
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.msg import auth as p_auth
from ceph_tpu_torch.msg import messenger as p_msgr
from test_torch_runtime import port_gates  # noqa: F401  (autouse)

KEY = bytes(range(32))
MSGRS = {"ceph_tpu": j_msgr, "port": p_msgr}
AUTHS = {"ceph_tpu": j_auth, "port": p_auth}

MESSAGES = {
    "plain": {"type": "ping", "n": 1, "s": "x", "f": 0.5, "none": None},
    "bytes": {"type": "write", "data": b"\x00\x01\xff" * 100},
    "views": {"type": "write", "data": memoryview(b"abcdef")[1:5],
              "more": bytearray(b"\x07" * 33)},
    "nested": {"type": "push", "shards": [{"i": i, "d": bytes([i]) * i}
                                          for i in range(5)],
               "meta": {"oid": "rbd_data.1", "v": [1, 2, (3, 4)]}},
    "empty_blob": {"type": "write", "data": b"", "tail": [b"", b"z"]},
    "sentinels": {"type": "echo", "a": {"__frame_blob__": 0},
                  "b": {"__frame_esc__": "x"},
                  "c": [{"__frame_blob__": 7}, b"real"]},
    "unicode": {"type": "log", "msg": "osd.3 — scrub éè"},
    "compressed": {"type": "map", "map": "A" * 40000, "blob": b"\x01" * 64},
    "many_blobs": {"type": "batch",
                   "items": [bytes([i % 256]) * (i + 1) for i in range(70)]},
    "sequenced": {"type": "op", "n": 9, "_s": 12, "_sess": "abcd",
                  "frm": "client.1", "tid": "77"},
    "trace": {"type": "call", "trace": {"trace_id": "t", "span_id": "s",
                                        "sampled": True}, "d": b"q"},
    "mac_field": {"type": "op", "mac": "stale", "d": b"1"},
}


@pytest.fixture(params=sorted(MESSAGES))
def message(request):
    return request.param, MESSAGES[request.param]


def _plain(obj):
    """Message values with every bytes-like leaf as ``bytes`` and tuples
    as lists (what a decoded frame holds)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _keyring(auth, signed):
    return auth.Keyring(KEY) if signed else None


@pytest.mark.parametrize("signed", [False, True])
def test_frames_byte_equal(message, signed):
    _name, msg = message
    j = j_msgr.encode_frame(msg, _keyring(j_auth, signed))
    p = p_msgr.encode_frame(msg, _keyring(p_auth, signed))
    assert p == j
    parts, nbytes = p_msgr.encode_frame_parts(msg)
    assert b"".join(bytes(x) for x in parts) == p_msgr.encode_frame(msg)
    assert nbytes == len(p_msgr.encode_frame(msg))


@pytest.mark.parametrize("writer,reader", [("port", "ceph_tpu"),
                                           ("ceph_tpu", "port")])
def test_frames_decode_across(message, writer, reader):
    name, msg = message
    w, r = MSGRS[writer], MSGRS[reader]
    kr_w = AUTHS[writer].Keyring(KEY)
    kr_r = AUTHS[reader].Keyring(KEY)
    frame = memoryview(w.encode_frame(msg, kr_w))
    got, blobs = r.decode_frame(frame)
    assert kr_r.verify(got, blobs)
    restored = r._restore_blobs(got, blobs)
    restored.pop("mac")
    want = _plain(msg)
    want.pop("mac", None)
    assert _plain(restored) == want
    assert all(isinstance(b, memoryview) for b in blobs)
    if name == "compressed":
        assert frame[1] & 0x01  # the control segment went through zlib


def _evil():
    body = json.dumps({"type": "ping"}).encode()

    def raw(body, nblobs, blob_parts=b"", flags=0, ver=2):
        return (struct.pack("<BBI", ver, flags, len(body)) + body
                + struct.pack("<I", nblobs) + blob_parts)

    bomb = zlib.compress(b"a" * (40 << 20), 6)
    return {
        "short": b"\x02\x00",
        "huge_blob_count": raw(body, 0xFFFFFFFF),
        "truncated_blob": raw(body, 1, struct.pack("<I", 1 << 30)),
        "control_past_end": struct.pack("<BBI", 2, 0, 1 << 20) + b"short",
        "bad_zlib": raw(b"not-zlib", 0, flags=1),
        "bomb": raw(bomb, 0, flags=1),
        "version": raw(body, 0, ver=9),
        "not_json": raw(b"\xff\xfe{", 0),
        "not_object": raw(b"[1, 2]", 0),
    }


EVIL = _evil()


@pytest.mark.parametrize("name", sorted(EVIL))
def test_malformed_frames_rejected_alike(name):
    payload = EVIL[name]
    with pytest.raises(JMalformed) as j:
        j_msgr.decode_frame(payload)
    with pytest.raises(PMalformed) as p:
        p_msgr.decode_frame(memoryview(payload))
    assert str(p.value) == str(j.value)


def test_blob_reference_out_of_range_alike():
    msg = {"type": "ping", "d": {"__frame_blob__": 3}}
    for mod, err in ((j_msgr, JMalformed), (p_msgr, PMalformed)):
        with pytest.raises(err, match="out of range"):
            mod._restore_blobs(msg, [b"x"])


def test_keyring_tickets_and_wire_equal_ceph_tpu():
    j, p = j_auth.Keyring(KEY), p_auth.Keyring(KEY)
    assert p.to_wire() == j.to_wire()
    assert p_auth.Keyring.from_wire(j.to_wire()).key == KEY
    t_j = j.issue_ticket("client.4", lifetime=60, now=1.7e9)
    t_p = p.issue_ticket("client.4", lifetime=60, now=1.7e9)
    assert t_p == t_j
    assert p_auth.encode_ticket(t_p) == j_auth.encode_ticket(t_j)
    assert p_auth.decode_ticket(j_auth.encode_ticket(t_j)) == t_j
    live = j.issue_ticket("client.4", lifetime=60)
    assert p.verify_ticket(live) and not p.verify_ticket(t_p)
    msg = {"type": "op", "n": 3, "_s": 1, "_sess": "x"}
    blobs = [b"payload"]
    assert p.sign(msg, blobs) == j.sign(msg, blobs)
    tampered = dict(msg, mac=j.sign(msg, blobs), n=4)
    assert not p.verify(tampered, blobs)
    assert not p.verify(dict(msg, mac=j.sign(msg, blobs)), [b"payloaX"])


@pytest.mark.parametrize("value", ["tensor", "ndarray"])
def test_arrays_never_travel_silently(value):
    """A tensor (or an ndarray) in a message raises ``TypeError`` in
    the port's codec, as ``ceph_tpu``'s JSON encoder does."""
    arr = torch.arange(4, dtype=torch.uint8) if value == "tensor" \
        else np.arange(4, dtype=np.uint8)
    msg = {"type": "write", "data": arr}
    with pytest.raises(TypeError):
        j_msgr.encode_frame(msg)
    with pytest.raises(TypeError, match="cannot travel"):
        p_msgr.encode_frame(msg)


# -- bufpool ----------------------------------------------------------

def _private_pool(bp, pc_mod, monkeypatch):
    """A fresh pool of ``bp``'s whose counters live in a collection of
    their own (the process-wide ``obs.bufpool`` logger stays as it is)."""
    coll = pc_mod.PerfCountersCollection()
    monkeypatch.setattr(bp, "collection", lambda: coll)
    pool = bp.BufferPool()
    pool._counters()
    monkeypatch.undo()
    return pool


SIZES = [1, 1000, 1024, 1025, 4096 + 3, 65536, (4 << 20) + 52,
         16 << 20, (16 << 20) + 1]


@pytest.mark.parametrize("n", SIZES)
def test_bufpool_size_classes_and_counters(n, monkeypatch):
    """Size classes, recycling and the ``obs.bufpool`` counters over the
    same acquire/release sequence equal ``ceph_tpu``'s."""
    out = []
    for bp, pc_mod in ((j_bufpool, j_pc), (p_bufpool, p_pc)):
        pool = _private_pool(bp, pc_mod, monkeypatch)
        rows = []
        for _ in range(3):
            segs = [pool.acquire(n, tag="t") for _ in range(3)]
            rows.append((len(segs[0].writable()), len(segs[0]._buf),
                         len(pool.outstanding()), segs[0].refs))
            segs[0].incref()
            for s in segs:
                s.release()
            rows.append((segs[0].refs, pool.free_buffers()))
            segs[0].release()
        rows.append(pool._counters().dump())
        out.append(rows)
    assert out[1] == out[0]
    assert p_bufpool.BufferPool._shift_for(n) == \
        j_bufpool.BufferPool._shift_for(n)


def test_bufpool_double_release_and_leak(monkeypatch):
    for bp, pc_mod in ((j_bufpool, j_pc), (p_bufpool, p_pc)):
        pool = _private_pool(bp, pc_mod, monkeypatch)
        seg = pool.acquire(100, tag="x")
        seg.release()
        with pytest.raises(bp.DoubleRelease):
            seg.release()
        with pytest.raises(bp.DoubleRelease):
            seg.incref()
        lost = pool.acquire(5000, tag="lost")
        del lost  # collected while still held: a leak, counted
        assert pool.leaked() == 1 and pool.outstanding() == []
        assert pool._counters().dump()["live_segments"] == 0


def test_views_are_zero_copy_slices_of_the_segment():
    seg = p_bufpool.acquire(64, tag="test")
    try:
        seg.writable()[:] = bytes(range(64))
        v = seg.view(8, 16)
        assert bytes(v) == bytes(range(8, 16))
        seg.writable()[8] = 200
        assert v[0] == 200
    finally:
        seg.release()


# -- live exchanges ---------------------------------------------------

def _warm(m):
    """Start every dispatch worker of ``m`` now: a pool creates its
    workers lazily, and a worker started during a test would count as
    a thread that test leaked."""
    go = threading.Event()
    for _ in range(16):
        m._pool_submit(go.wait, 5)
    for _ in range(4):
        m._pool_submit(go.wait, 5, control=True)
    go.set()


class _Server:
    def __init__(self, mod, keyring):
        self.m = mod.Messenger(f"srv-{mod.__name__.split('.')[0]}",
                               lossless=True, keyring=keyring)
        self.seen = []
        self.lock = threading.Lock()
        self.m.register("echo", self.echo)
        self.m.register("count", self.count)
        self.m.register("fifo", self.count, ordered=True)
        self.m.register("fail", self.fail)
        self.m.start()
        _warm(self.m)

    def echo(self, msg):
        return {"back": {k: msg[k] for k in msg
                         if k not in ("trace", "tid", "_s", "_sess", "mac", "frm")},
                "sizes": [len(b) for b in msg.get("blobs", [])]}

    def count(self, msg):
        with self.lock:
            self.seen.append(msg["n"])
        return {"n": msg["n"]} if msg.get("tid") else None

    def fail(self, msg):
        raise ValueError("handler refused")


@pytest.fixture(scope="module")
def links():
    """A lossless signed server of each package, and four clients of
    each package (lossless and lossy, both servers) already connected."""
    servers = {pkg: _Server(MSGRS[pkg], AUTHS[pkg].Keyring(KEY))
               for pkg in MSGRS}
    clients = {}
    for pkg in MSGRS:
        for lossless in (True, False):
            c = MSGRS[pkg].Messenger(
                f"cli-{pkg}-{'ll' if lossless else 'ly'}",
                lossless=lossless, keyring=AUTHS[pkg].Keyring(KEY))
            c.start()
            _warm(c)
            for srv in servers.values():
                c.call(srv.m.addr, {"type": "echo"}, timeout=10)
            clients[(pkg, lossless)] = c
    yield servers, clients
    for m in list(clients.values()) + [s.m for s in servers.values()]:
        m.shutdown()


DIRECTIONS = [("port", "ceph_tpu"), ("ceph_tpu", "port"), ("port", "port")]


@pytest.mark.parametrize("lossless", [True, False])
def test_dialed_connection_waits_for_a_slow_reply(links, lossless):
    """A fault of ``ceph_tpu`` that the port does not copy: its
    ``_connect`` leaves ``create_connection``'s 5 s dial timeout on the
    socket, so the connection's reader gives up after 5 s without a
    frame and every call waiting on it fails with "connection lost",
    whatever its own timeout (a busy cluster's EC writes failed so).
    The port dials with the bound and then reads without one."""
    servers, clients = links
    for pkg, want in (("ceph_tpu", 5.0), ("port", None)):
        cli = clients[(pkg, lossless)]
        for srv in servers.values():
            assert cli._conns[tuple(srv.m.addr)].gettimeout() == want


@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_live_exchange(links, client, server, lossless):
    servers, clients = links
    srv, cli = servers[server], clients[(client, lossless)]
    msg = {"type": "echo", "n": 5, "data": bytes(range(256)) * 64,
           "blobs": [b"a" * 3, bytearray(b"b" * 70000), b""],
           "lit": {"__frame_blob__": 1}, "map": "M" * 30000}
    rep = cli.call(srv.m.addr, msg, timeout=10)
    assert _plain(rep["back"]) == _plain({k: v for k, v in msg.items()
                                          if k != "type"} | {"type": "echo"})
    assert rep["sizes"] == [3, 70000, 0]
    assert cli.call(srv.m.addr, {"type": "fail"}, timeout=10) == {
        "error": "handler refused"}
    assert "no handler" in cli.call(srv.m.addr, {"type": "nope"},
                                    timeout=10)["error"]
    base = len(srv.seen)
    for n in range(20):
        cli.send(srv.m.addr, {"type": "count", "n": n, "pad": b"p" * n})
    deadline = time.monotonic() + 10
    while len(srv.seen) < base + 20 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert sorted(srv.seen[base:]) == list(range(20))


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_live_ordered_lane(links, client, server):
    servers, clients = links
    srv, cli = servers[server], clients[(client, True)]
    base = len(srv.seen)
    for n in range(40):
        cli.send(srv.m.addr, {"type": "fifo", "n": n})
    deadline = time.monotonic() + 10
    while len(srv.seen) < base + 40 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert srv.seen[base:] == list(range(40))


def test_dump_messenger_shape_equals_ceph_tpu(links):
    servers, _clients = links
    j = servers["ceph_tpu"].m.dump_messenger()
    p = servers["port"].m.dump_messenger()
    assert sorted(p) == sorted(j)
    assert sorted(p["totals"]) == sorted(j["totals"])
    assert sorted(p["connections"][0]) == sorted(j["connections"][0])
    assert p["totals"]["frames_in"] >= 4


def _pair(server_pkg, client_pkg, **server_kw):
    srv = MSGRS[server_pkg].Messenger("server", lossless=True,
                                      keyring=AUTHS[server_pkg].Keyring(KEY),
                                      **server_kw)
    cli = MSGRS[client_pkg].Messenger("client-side", lossless=True,
                                      keyring=AUTHS[client_pkg].Keyring(KEY))
    srv.start()
    cli.start()
    return srv, cli


@pytest.mark.parametrize("client,server", DIRECTIONS)
def test_dropped_connection_replays_nothing_lost_nothing_duplicated(
        client, server):
    srv, cli = _pair(server, client)
    seen, lock, errors = [], threading.Lock(), []

    def h(msg):
        with lock:
            seen.append(msg["n"])
        return {"n": msg["n"]}

    srv.register("op", h)
    n_each, writers = 25, 3

    def writer(w):
        for i in range(n_each):
            n = w * n_each + i
            try:
                rep = cli.call(srv.addr, {"type": "op", "n": n,
                                          "d": bytes([n % 256]) * 512},
                               timeout=20)
                assert rep["n"] == n
            except Exception as e:  # asserted below
                errors.append((n, e))

    try:
        threads = [threading.Thread(target=writer, args=(w,))
                   for w in range(writers)]
        for t in threads:
            t.start()
        for _ in range(4):
            time.sleep(0.05)
            with cli._conn_lock:
                socks = list(cli._conns.values())
            for s in socks:
                s.close()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert sorted(seen) == list(range(n_each * writers))
    finally:
        cli.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("writer", ["ceph_tpu", "port"])
def test_replayed_capture_is_not_executed(writer):
    """A signed frame captured from one session and replayed verbatim
    (here encoded by either package's codec) reaches the port's server
    as a duplicate: the handler runs once."""
    srv, cli = _pair("port", "port")
    calls = []
    srv.register("op", lambda m: calls.append(m["n"]) or {"ok": True})
    try:
        assert cli.call(srv.addr, {"type": "op", "n": 1}, timeout=10)["ok"]
        frame = {"type": "op", "n": 1, "_s": 1, "_sess": cli.session_id,
                 "frm": cli.name}
        raw = socket.create_connection(srv.addr, timeout=5)
        try:
            MSGRS[writer]._send_frame(raw, frame, AUTHS[writer].Keyring(KEY))
            time.sleep(0.1)
        finally:
            raw.close()
        assert calls == [1]
    finally:
        cli.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("server", ["ceph_tpu", "port"])
def test_tampered_frame_is_dropped(server):
    srv, cli = _pair(server, "port")
    calls = []
    srv.register("op", lambda m: calls.append(m["n"]) or {"ok": True})
    try:
        frame = {"type": "op", "n": 7, "_s": 1, "_sess": cli.session_id,
                 "frm": cli.name}
        frame["mac"] = p_auth.Keyring(KEY).sign(frame)
        frame["n"] = 8
        raw = socket.create_connection(srv.addr, timeout=5)
        try:
            p_msgr._send_frame(raw, frame)
            time.sleep(0.1)
        finally:
            raw.close()
        assert calls == []
        assert cli.call(srv.addr, {"type": "op", "n": 9},
                        timeout=10) == {"ok": True}
        assert calls == [9]
    finally:
        cli.shutdown()
        srv.shutdown()


@pytest.mark.parametrize("client", ["ceph_tpu", "port"])
def test_throttle_bounds_inflight_bytes(client):
    th = Throttle("big", 40_000)  # two ~17 KB frames fit, three do not
    srv, cli = _pair("port", client, throttles={"big": th})
    inflight, peak, lock = [0], [0], threading.Lock()

    def h(msg):
        with lock:
            inflight[0] += 1
            peak[0] = max(peak[0], inflight[0])
        time.sleep(0.05)
        with lock:
            inflight[0] -= 1
        return {"ok": True}

    srv.register("big", h)
    try:
        blob = b"x" * 16_000
        threads = [threading.Thread(target=lambda: cli.call(
            srv.addr, {"type": "big", "d": blob}, timeout=20))
            for _ in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert 1 <= peak[0] <= 2, f"throttle admitted {peak[0]} at once"
        assert th.get_current() == 0
        rep = cli.call(srv.addr, {"type": "big", "d": b"y" * 50_000},
                       timeout=10)
        assert rep == {"error": "message too large"}
    finally:
        cli.shutdown()
        srv.shutdown()
