"""The port's stores (``ceph_tpu_torch/os``, ``common/bincode``,
``analysis/faults``, ``analysis/racecheck``, ``tools/objectstore_tool``)
against ``ceph_tpu``'s.

The store cases of ``test_objectstore.py``, ``test_wal_store.py`` and
``test_faults.py`` that need no cluster run on both packages
(parametrised by ``pkg``); the bytes the stores write (WAL records,
checkpoints, exports, the tool's output) are held equal across them; a
WAL directory written by either mounts in the other; the committed
corpus blobs decode in the port and re-encode to the same bytes.
Everything is bytes: no tolerance.
"""

import base64
import contextlib
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

import ceph_tpu.analysis.faults as ref_faults
import ceph_tpu.common.bincode as ref_bincode
import ceph_tpu.common.compressor as ref_compressor
import ceph_tpu.os.kv as ref_kv
import ceph_tpu.os.memstore as ref_memstore
import ceph_tpu.os.objectstore as ref_objectstore
import ceph_tpu.os.wal_store as ref_wal
import ceph_tpu.tools.objectstore_tool as ref_tool
import ceph_tpu_torch.analysis.faults as port_faults
import ceph_tpu_torch.analysis.lockdep as port_lockdep
import ceph_tpu_torch.analysis.racecheck as port_racecheck
import ceph_tpu_torch.common.bincode as port_bincode
import ceph_tpu_torch.common.compressor as port_compressor
import ceph_tpu_torch.common.copytrack as port_copytrack
import ceph_tpu_torch.common.log as port_log
import ceph_tpu_torch.os.kv as port_kv
import ceph_tpu_torch.os.memstore as port_memstore
import ceph_tpu_torch.os.objectstore as port_objectstore
import ceph_tpu_torch.os.wal_store as port_wal
import ceph_tpu_torch.tools.objectstore_tool as port_tool
from ceph_tpu.common.encoding import MalformedInput as RefMalformed
from ceph_tpu_torch.common.encoding import MalformedInput as PortMalformed

REPO = Path(__file__).resolve().parent.parent
CORPUS = REPO / "tests" / "corpus" / "encodings"

PKGS = {
    "ceph_tpu": types.SimpleNamespace(
        name="ceph_tpu", faults=ref_faults, bincode=ref_bincode,
        compressor=ref_compressor, kv=ref_kv, memstore=ref_memstore,
        objectstore=ref_objectstore, wal=ref_wal, tool=ref_tool,
        Malformed=RefMalformed),
    "ceph_tpu_torch": types.SimpleNamespace(
        name="ceph_tpu_torch", faults=port_faults, bincode=port_bincode,
        compressor=port_compressor, kv=port_kv, memstore=port_memstore,
        objectstore=port_objectstore, wal=port_wal, tool=port_tool,
        Malformed=PortMalformed),
}


@pytest.fixture(autouse=True)
def _port_gates():
    """Fail a test on new violations of the port's lockdep and
    racecheck (``tests/conftest.py`` gates ``ceph_tpu``'s), and disarm
    both packages' failpoints afterwards."""
    base = len(port_lockdep.violations())
    race_base = port_racecheck.mark()
    yield
    port_faults.reset()
    ref_faults.reset()
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


def T(pkg):
    return pkg.objectstore.Transaction()


def make_wal(pkg, path, **kw):
    st = pkg.wal.WALStore(str(path), **kw)
    st.mkfs()
    st.mount()
    return st


def mem_store(pkg):
    st = pkg.memstore.MemStore()
    st.queue_transaction(T(pkg).create_collection("pg1"))
    return st


def state(st):
    """A store's whole state as plain values."""
    return {cid: {oid: (st.read(cid, oid), st.stat(cid, oid),
                        st.omap_get(cid, oid))
                  for oid in st.list_objects(cid)}
            for cid in st.list_collections()}


# -- MemStore (test_objectstore.py) ------------------------------------


def test_memstore_extents_zero_truncate_remove(pkg):
    st = mem_store(pkg)
    st.queue_transaction(T(pkg).write("pg1", "obj", 0, b"hello")
                         .write("pg1", "obj", 10, b"world"))
    assert st.read("pg1", "obj") == b"hello\0\0\0\0\0world"
    assert st.read("pg1", "obj", 10, 5) == b"world"
    st.queue_transaction(T(pkg).write("pg1", "o", 0, b"x" * 16))
    st.queue_transaction(T(pkg).zero("pg1", "o", 4, 8))
    assert st.read("pg1", "o") == b"xxxx" + b"\0" * 8 + b"xxxx"
    st.queue_transaction(T(pkg).zero("pg1", "o", 16, 8))
    assert st.stat("pg1", "o")["size"] == 24
    st.queue_transaction(T(pkg).truncate("pg1", "o", 4))
    assert st.read("pg1", "o") == b"xxxx"
    st.queue_transaction(T(pkg).truncate("pg1", "o", 8))
    assert st.read("pg1", "o") == b"xxxx\0\0\0\0"
    st.queue_transaction(T(pkg).remove("pg1", "o"))
    assert st.stat("pg1", "o") is None


def test_memstore_clone_attrs_omap(pkg):
    st = mem_store(pkg)
    st.queue_transaction(
        T(pkg).write("pg1", "src", 0, b"abc")
        .setattr("pg1", "src", "version", b"7")
        .omap_setkeys("pg1", "src", {"k1": b"v1", "k2": b"v2"}))
    st.queue_transaction(T(pkg).clone("pg1", "src", "dst"))
    st.queue_transaction(T(pkg).write("pg1", "src", 0, b"zzz"))
    assert st.read("pg1", "dst") == b"abc"
    assert st.getattr("pg1", "dst", "version") == b"7"
    st.queue_transaction(T(pkg).omap_rmkeys("pg1", "dst", ["k1"]))
    assert st.omap_get("pg1", "dst") == {"k2": b"v2"}
    st.queue_transaction(T(pkg).rmattr("pg1", "dst", "version")
                         .omap_clear("pg1", "src"))
    assert st.getattr("pg1", "dst", "version") is None
    assert st.omap_get("pg1", "src") == {}


def test_memstore_atomicity_and_collections(pkg):
    st = mem_store(pkg)
    st.queue_transaction(T(pkg).write("pg1", "a", 0, b"keep"))
    with pytest.raises(pkg.memstore.TransactionError):
        st.queue_transaction(T(pkg).write("pg1", "a", 0, b"clobbered")
                             .remove("pg1", "missing"))
    assert st.read("pg1", "a") == b"keep"
    with pytest.raises(pkg.memstore.TransactionError):
        st.queue_transaction(T(pkg).create_collection("pg1"))
    with pytest.raises(pkg.memstore.TransactionError):
        st.queue_transaction(T(pkg).remove_collection("pg1"))
    st.queue_transaction(T(pkg).remove("pg1", "a").remove_collection("pg1"))
    assert not st.collection_exists("pg1")
    with pytest.raises(pkg.memstore.TransactionError):
        st.queue_transaction(T(pkg).touch("nope", "o"))


def test_memstore_export_import(pkg):
    st = mem_store(pkg)
    st.queue_transaction(
        T(pkg).write("pg1", "o", 0, bytes(range(256)))
        .setattr("pg1", "o", "hinfo", b"\x01\x02")
        .omap_setkeys("pg1", "o", {"epoch": b"5"}))
    st2 = pkg.memstore.MemStore.import_state(st.export_state())
    assert state(st2) == state(st)
    st3 = pkg.memstore.MemStore.import_blob(st.export_blob())
    assert state(st3) == state(st)


def test_memstore_concurrent_transactions(pkg):
    st = mem_store(pkg)

    def worker(tid):
        for i in range(50):
            st.queue_transaction(T(pkg).write("pg1", f"o-{tid}-{i}", 0,
                                              b"x"))

    ths = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for th in ths:
        th.start()
    for th in ths:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in ths)
    assert len(st.list_objects("pg1")) == 200


def test_export_blob_equal_across_packages():
    ops = []
    for p in PKGS.values():
        st = mem_store(p)
        st.queue_transaction(
            T(p).write("pg1", "o", 3, b"\x00\xffdata")
            .setattr("pg1", "o", "v", b"1'2")
            .omap_setkeys("pg1", "o", {"a": b"", "b": b"\x01"}))
        ops.append(st.export_blob())
    assert ops[0] == ops[1]


def test_kv_over_both_stores_equal(tmp_path):
    """KeyValueDB over a MemStore and over a WALStore gives the values
    ``ceph_tpu``'s gives, and the WAL bytes are the same."""
    got = []
    for name, p in sorted(PKGS.items()):
        wal = make_wal(p, tmp_path / name)
        for store in (p.memstore.MemStore(), wal):
            db = p.kv.KeyValueDB(store)
            db.submit_transaction(p.kv.KVTransaction()
                                  .set("osdmap", "full_1", b"\x00" * 9)
                                  .set("osdmap", "inc_2", b"{}")
                                  .set("pgmap", "x", b"1"))
            db.submit_transaction(p.kv.KVTransaction()
                                  .rmkey("osdmap", "inc_2")
                                  .rmkeys_by_prefix("pgmap"))
            got.append((db.get("osdmap", "full_1"), db.get("osdmap", "x"),
                        db.get_by_prefix("osdmap"), list(db.iterator(
                            "osdmap")), db.get_by_prefix("pgmap")))
        got.append((tmp_path / name / "wal.log").read_bytes())
    assert got[0] == got[1] == got[3] == got[4]
    assert got[2] == got[5]


# -- bincode and the WAL codecs ----------------------------------------


def _txn_ops(pkg):
    t = T(pkg)
    t.create_collection("pg1")
    t.write("pg1", "obj", 4, b"\x00\xffdata")
    t.setattr("pg1", "obj", "hinfo", b"\x01\x02")
    t.omap_setkeys("pg1", "obj", {"k1": b"v1", "k2": b""})
    t.omap_rmkeys("pg1", "obj", ["k2"])
    t.truncate("pg1", "obj", 3)
    t.zero("pg1", "obj", 1, 1)
    t.clone("pg1", "obj", "c")
    return t.ops


def test_wal_record_and_checkpoint_bytes_equal(pkg):
    """``pkg``'s codecs give the bytes the other package's give, and
    read the other's."""
    other = PKGS["ceph_tpu" if pkg.name != "ceph_tpu" else
                 "ceph_tpu_torch"]
    ops = _txn_ops(pkg)
    rec = pkg.wal.encode_record(7, ops)
    assert rec == other.wal.encode_record(7, _txn_ops(other))
    seq, payload, end = other.wal.decode_record(rec)
    assert (seq, end) == (7, len(rec))
    assert other.bincode.decode_txn(other.bincode.Decoder(payload)) == ops
    st = mem_store(pkg)
    st.queue_transaction(T(pkg).write("pg1", "o", 0, b"A" * 5000)
                         .setattr("pg1", "o", "crc", b"12")
                         .omap_setkeys("pg1", "o", {"k": b"v"}))
    for codec in ("none", "zlib", "lzma"):
        blob = pkg.wal.encode_checkpoint(
            3, st._coll, pkg.compressor.Compressor(codec))
        seq, colls = other.wal.decode_checkpoint(blob)
        assert seq == 3
        assert other.wal.encode_checkpoint(
            3, colls, other.compressor.Compressor(codec)) == blob


@pytest.mark.parametrize("case", ["truncated", "magic", "crc", "tag"])
def test_bad_record_and_checkpoint_are_typed(pkg, case):
    rec = bytearray(pkg.wal.encode_record(1, _txn_ops(pkg)))
    if case == "truncated":
        rec = rec[:-3]
    elif case == "magic":
        rec[0] ^= 1
    elif case == "crc":
        rec[-1] ^= 0xFF
    else:
        body = bytes([5]) + b"zstd9" + b"\0" * 8
        rec = pkg.wal._HDR.pack(pkg.wal._MAGIC_Z, 1, len(body),
                                pkg.wal._crc32c(body)) + body
        with pytest.raises(pkg.Malformed, match="os.wal_checkpoint"):
            pkg.wal.decode_checkpoint(bytes(rec))
        return
    with pytest.raises(pkg.Malformed, match="os.wal_record"):
        pkg.wal.decode_record(bytes(rec))


def test_crc32c_equal():
    for data in (b"", b"a", bytes(range(256)) * 37, b"\xff" * 4097):
        assert port_wal._crc32c(data) == ref_wal._crc32c(data)


def _corpus(name):
    return sorted((CORPUS / name).glob("*/*.bin"))


@pytest.mark.parametrize("name", ["os.wal_record", "os.wal_checkpoint",
                                  "os.memstore_export", "os.txn"])
def test_store_corpus_decodes_and_reencodes(name):
    blobs = _corpus(name)
    assert blobs
    for path in blobs:
        raw = path.read_bytes()
        current = path.parent.name != "0"
        if name == "os.txn":
            ops = port_bincode.decode_txn(port_bincode.Decoder(raw))
            enc = port_bincode.Encoder()
            port_bincode.encode_txn(ops, enc)
            assert enc.bytes() == raw
            assert ops == ref_bincode.decode_txn(ref_bincode.Decoder(raw))
        elif name == "os.wal_record":
            seq, payload, _ = port_wal.decode_record(raw)
            ops = port_bincode.decode_txn(port_bincode.Decoder(payload))
            assert port_wal.encode_record(seq, ops) == raw
        elif name == "os.wal_checkpoint":
            seq, colls = port_wal.decode_checkpoint(raw)
            assert port_wal.encode_checkpoint(
                seq, colls, port_compressor.Compressor("zlib")) == raw
            _, rcolls = ref_wal.decode_checkpoint(raw)
            assert {c: {o: (bytes(v.data), v.xattr, v.omap)
                        for o, v in objs.items()}
                    for c, objs in colls.items()} == \
                {c: {o: (bytes(v.data), v.xattr, v.omap)
                     for o, v in objs.items()}
                 for c, objs in rcolls.items()}
        else:
            st = port_memstore.MemStore.import_blob(raw)
            assert st.export_state() == \
                ref_memstore.MemStore.import_blob(raw).export_state()
            if current:
                assert st.export_blob().encode() == raw


# -- WALStore (test_wal_store.py) --------------------------------------


def test_wal_mount_replays_and_umount_truncates(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s")
    st.queue_transaction(T(pkg).create_collection("pg1")
                         .write("pg1", "a", 0, b"hello"))
    st.queue_transaction(T(pkg).write("pg1", "a", 5, b" world"))
    st.queue_transaction(T(pkg).omap_setkeys("pg1", "a", {"v": b"1"}))
    st2 = pkg.wal.WALStore(st.path)  # no umount: a crash
    st2.mount()
    assert st2.read("pg1", "a") == b"hello world"
    assert st2.omap_get("pg1", "a") == {"v": b"1"}
    assert st2._seq == 3
    st2.umount()
    assert os.path.getsize(os.path.join(st.path, "wal.log")) == 0
    st3 = pkg.wal.WALStore(st.path)
    st3.mount()
    assert st3.read("pg1", "a") == b"hello world"


def test_wal_torn_and_corrupt_tail(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s")
    st.queue_transaction(T(pkg).create_collection("pg1"))
    for i in range(5):
        st.queue_transaction(T(pkg).write("pg1", f"o{i}", 0,
                                          bytes([i]) * 64))
    wal = os.path.join(st.path, "wal.log")
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 40)
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert st2.list_objects("pg1") == [f"o{i}" for i in range(4)]
    # the torn tail was cut: a later write survives the next mount
    st2.queue_transaction(T(pkg).write("pg1", "post", 0, b"p"))
    data = bytearray(open(wal, "rb").read())
    st3 = pkg.wal.WALStore(st.path)
    st3.mount()
    assert st3.list_objects("pg1") == ["o0", "o1", "o2", "o3", "post"]
    data[-1] ^= 0xFF
    open(wal, "wb").write(data)
    st4 = pkg.wal.WALStore(st.path)
    st4.mount()
    assert st4.list_objects("pg1") == [f"o{i}" for i in range(4)]


def test_wal_checkpoints(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s", checkpoint_every_bytes=4096)
    st.queue_transaction(T(pkg).create_collection("pg1"))
    for i in range(8):
        st.queue_transaction(T(pkg).write("pg1", f"o{i}", 0, b"z" * 1024))
    assert st._ckpt_seq > 0
    st.checkpoint()
    st.queue_transaction(T(pkg).write("pg1", "post", 0, b"post"))
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert len(st2.list_objects("pg1")) == 9
    assert st2.read("pg1", "post") == b"post"


def test_wal_failed_txn_never_journals(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s")
    st.queue_transaction(T(pkg).create_collection("pg1"))
    seq = st._seq
    with pytest.raises(Exception):
        st.queue_transaction(T(pkg).write("pg1", "a", 0, b"ok")
                             .remove("pg1", "missing"))
    assert st._seq == seq
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert st2.list_objects("pg1") == []


def test_wal_journal_failure_rolls_back(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s")
    st.queue_transaction(T(pkg).create_collection("c")
                         .write("c", "o", 0, b"base"))
    st._wal_f.close()
    with pytest.raises(ValueError):
        st.queue_transaction(T(pkg).write("c", "o", 0, b"FAIL"))
    assert st.read("c", "o") == b"base"
    st.queue_transaction(T(pkg).write("c", "o", 0, b"good"))
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert st2.read("c", "o") == b"good"


def test_wal_group_commit(pkg, tmp_path):
    """One writer: a shared fsync a txn.  Eight writers: fewer fsyncs
    than txns, every acked txn durable across a remount; a checkpoint
    mid-group completes the group."""
    pc = pkg.wal._pc
    st = make_wal(pkg, tmp_path / "a")
    base = pc.dump()
    st.queue_transaction(T(pkg).create_collection("pg1"))
    st.queue_transaction(T(pkg).write("pg1", "a", 0, b"x"))
    cur = pc.dump()
    assert cur["txns"] - base["txns"] == 2
    assert cur["group_commits"] - base["group_commits"] == 2

    for path, kw, n in ((tmp_path / "b",
                         dict(group_commit_max_delay_us=5000), 8),
                        (tmp_path / "c", dict(checkpoint_every_bytes=2048,
                                              group_commit_max_delay_us=2000),
                         4)):
        st = make_wal(pkg, path, **kw)
        st.queue_transaction(T(pkg).create_collection("pg1"))
        base = pc.dump()

        def worker(tid):
            for i in range(4):
                st.queue_transaction(T(pkg).write(
                    "pg1", f"o-{tid}-{i}", 0, b"z" * 512))

        ths = [threading.Thread(target=worker, args=(t,)) for t in range(n)]
        for th in ths:
            th.start()
        for th in ths:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in ths)
        cur = pc.dump()
        assert cur["txns"] - base["txns"] == 4 * n
        if "checkpoint_every_bytes" in kw:
            assert st._ckpt_seq > 0
        else:
            assert cur["group_commits"] - base["group_commits"] < 4 * n
        st2 = pkg.wal.WALStore(st.path)
        st2.mount()
        assert len(st2.list_objects("pg1")) == 4 * n


def test_wal_compression_and_bad_checkpoints(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "c", compression="zlib")
    st.queue_transaction(T(pkg).create_collection("c")
                         .write("c", "o", 0, b"A" * 100_000))
    st.umount()
    assert os.path.getsize(os.path.join(st.path, "checkpoint")) < 10_000
    for codec in ("none", "lzma"):
        s = pkg.wal.WALStore(st.path, compression=codec)
        s.mount()
        assert s.read("c", "o") == b"A" * 100_000
        s.umount()
    # a truncated checkpoint: mount from the WAL, the loss surfaced
    st = make_wal(pkg, tmp_path / "t")
    st.queue_transaction(T(pkg).create_collection("pg1"))
    st.checkpoint()
    st.queue_transaction(T(pkg).create_collection("pg2"))
    raw = open(st._ckpt_path, "rb").read()
    open(st._ckpt_path, "wb").write(raw[:-7])
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert "undecodable" in st2.last_mount_error
    assert st2.list_collections() == ["pg2"]


_CHILD = r"""
import sys
from ceph_tpu_torch.os.objectstore import Transaction
from ceph_tpu_torch.os.wal_store import WALStore

st = WALStore(sys.argv[1])
st.mkfs()
st.mount()
st.queue_transaction(Transaction().create_collection("pg1"))
print("ack 0", flush=True)
i = 0
while True:
    i += 1
    t = Transaction().write("pg1", "o%d" % i, 0, bytes([i % 256]) * 512)
    t.omap_setkeys("pg1", "o%d" % i, {"seq": str(i).encode()})
    st.queue_transaction(t)
    print("ack %d" % i, flush=True)
"""


def test_kill9_mid_burst_port_child(tmp_path):
    """kill -9 a child that imports only ``ceph_tpu_torch`` mid-burst:
    every acked write survives, the state is a prefix, and ``ceph_tpu``
    mounts the same directory to the same state."""
    port_wal._crc32c(b"x")  # the native crc32c is built before the child
    path = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, path],
                            stdout=subprocess.PIPE, text=True, env=env,
                            cwd=str(REPO))
    acked = -1
    deadline = time.monotonic() + 60
    while acked < 25 and time.monotonic() < deadline:
        line = proc.stdout.readline()
        if line.startswith("ack "):
            acked = int(line.split()[1])
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait()
    proc.stdout.close()
    assert acked >= 25, "child too slow to ack writes"
    st = port_wal.WALStore(path)
    st.mount()
    objs = st.list_objects("pg1")
    for i in range(1, acked + 1):
        assert st.read("pg1", f"o{i}") == bytes([i % 256]) * 512
        assert st.omap_get("pg1", f"o{i}")["seq"] == str(i).encode()
    seqs = sorted(int(o[1:]) for o in objs)
    assert seqs == list(range(1, len(seqs) + 1))
    ref = ref_wal.WALStore(path)
    ref.mount()
    assert state(ref) == state(st)


# -- across the packages -----------------------------------------------


@pytest.mark.parametrize("codec", ["none", "zlib", "lzma"])
@pytest.mark.parametrize("writer", sorted(PKGS))
def test_wal_directory_mounts_across_packages(tmp_path, writer, codec):
    """A directory written by one package (WAL records, then a
    checkpoint and more records) mounts in the other with equal state;
    the same transactions through both give the same files."""
    files = {}
    for name, p in sorted(PKGS.items()):
        st = make_wal(p, tmp_path / name, compression=codec)
        st.queue_transaction(T(p).create_collection("pg1")
                             .write("pg1", "a", 0, b"x" * 3000)
                             .setattr("pg1", "a", "v", b"1'1"))
        st.checkpoint()
        st.queue_transaction(T(p).omap_setkeys("pg1", "a", {"k": b"v"})
                             .write("pg1", "b", 7, b"tail"))
        files[name] = {f: (tmp_path / name / f).read_bytes()
                       for f in ("checkpoint", "wal.log")}
    assert files["ceph_tpu"] == files["ceph_tpu_torch"]
    reader = PKGS["ceph_tpu" if writer == "ceph_tpu_torch" else
                  "ceph_tpu_torch"]
    got = reader.wal.WALStore(str(tmp_path / writer), compression=codec)
    got.mount()
    want = PKGS[writer].wal.WALStore(str(tmp_path / writer))
    want.mount()
    assert state(got) == state(want)
    assert got._seq == want._seq == 2


# -- the failpoints (test_faults.py's store cases) ----------------------


def _registry_run(f):
    """The registry's arms on ``f`` (a faults module); returns what a
    seeded run drew."""
    assert not f.fires("os.read_eio")
    f.arm("os.read_eio", "count", count=3)
    assert sum(f.fires("os.read_eio") for _ in range(10)) == 3
    assert f.snapshot()["os.read_eio"] == 3
    assert not f._ACTIVE
    f.seed(42)
    f.arm("store.bit_rot", "p", p=0.5)
    draws = [f.fires("store.bit_rot") for _ in range(64)]
    f.apply_spec("os.fsync_eio=count:2,who:osd.1")
    assert set(f.list_faults()["armed"]) == {"os.fsync_eio"}
    assert not f.fires("os.fsync_eio", "osd.2")
    assert f.fires("os.fsync_eio", "osd.1")
    f.apply_spec("")
    with pytest.raises(ValueError):
        f.parse_spec("os.eat_bytes=oneshot")
    f.seed(7)
    return draws, f.flip_byte(b"abcdef")


def test_failpoint_registry(pkg):
    draws, flipped = _registry_run(pkg.faults)
    assert 5 < sum(draws) < 60
    assert sum(a != b for a, b in zip(flipped, b"abcdef")) == 1


def test_failpoints_draw_equal_across_packages():
    got = [_registry_run(p.faults) for p in PKGS.values()]
    assert got[0] == got[1]


def test_memstore_read_eio_and_bit_rot(pkg):
    st = mem_store(pkg)
    st.queue_transaction(T(pkg).write("pg1", "a", 0, b"hello"))
    pkg.faults.arm("os.read_eio", "oneshot")
    with pytest.raises(OSError):
        st.read("pg1", "a")
    assert st.read("pg1", "a") == b"hello"
    pkg.faults.seed(3)
    pkg.faults.arm("store.bit_rot", "oneshot")
    rotted = st.read("pg1", "a")
    assert rotted != b"hello" and len(rotted) == 5
    assert sum(a != b for a, b in zip(rotted, b"hello")) == 1
    assert st.read("pg1", "a") == b"hello"


def test_port_failpoints_do_not_arm_the_reference():
    st = mem_store(PKGS["ceph_tpu"])
    port_faults.arm("os.read_eio", "oneshot")
    st.queue_transaction(T(PKGS["ceph_tpu"]).write("pg1", "a", 0, b"x"))
    assert st.read("pg1", "a") == b"x"  # the reference's plane is unarmed
    port = mem_store(PKGS["ceph_tpu_torch"])
    port.queue_transaction(T(PKGS["ceph_tpu_torch"]).write("pg1", "a", 0,
                                                           b"x"))
    with pytest.raises(OSError):
        port.read("pg1", "a")


def test_wal_torn_append_and_fsync_eio(pkg, tmp_path):
    st = make_wal(pkg, tmp_path / "s")
    st.queue_transaction(T(pkg).create_collection("pg1")
                         .write("pg1", "a", 0, b"good"))
    pkg.faults.arm("os.torn_append", "oneshot")
    with pytest.raises(OSError):
        st.queue_transaction(T(pkg).write("pg1", "torn", 0, b"x" * 512))
    with pytest.raises(KeyError):
        st.read("pg1", "torn")
    st.queue_transaction(T(pkg).write("pg1", "b", 0, b"after"))
    st2 = pkg.wal.WALStore(st.path)
    st2.mount()
    assert st2.read("pg1", "b") == b"after"
    with pytest.raises(KeyError):
        st2.read("pg1", "torn")
    pkg.faults.arm("os.fsync_eio", "oneshot")
    with pytest.raises(OSError):
        st2.queue_transaction(T(pkg).create_collection("pg2"))
    with pytest.raises((OSError, AssertionError)):
        st2.queue_transaction(T(pkg).create_collection("pg3"))


# -- objectstore_tool --------------------------------------------------


def _tool_dir(path):
    p = PKGS["ceph_tpu"]
    st = make_wal(p, path)
    st.queue_transaction(
        T(p).create_collection("1.0").create_collection("2.3")
        .write("1.0", "rbd_data.1", 0, bytes(range(200)))
        .setattr("1.0", "rbd_data.1", "size", b"200")
        .setattr("1.0", "rbd_data.1", "v", b"3'7")
        .omap_setkeys("1.0", "rbd_data.1", {"snap": b"\x01"})
        .write("2.3", "obj", 0, b"ec shard"))
    st.umount()


def _run_tool(pkg, argv, stdin=""):
    out = io.StringIO()
    old_in = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = pkg.tool.main(argv)
    finally:
        sys.stdin = old_in
    return rc, out.getvalue()


def test_objectstore_tool_output_equal(tmp_path):
    """list, dump and export print the same in both packages on copies
    of one directory; import and remove leave equal stores."""
    _tool_dir(tmp_path / "orig")
    outs = {}
    for name, p in sorted(PKGS.items()):
        d = tmp_path / name
        shutil.copytree(tmp_path / "orig", d)
        base = ["--data-path", str(d)]
        got = [_run_tool(p, base + ["--op", "list"]),
               _run_tool(p, base + ["--op", "list", "--pgid", "2.3"]),
               _run_tool(p, base + ["--op", "dump", "--pgid", "1.0",
                                    "--oid", "rbd_data.1"])]
        export = _run_tool(p, base + ["--op", "export", "--pgid", "1.0"])
        got.append(export)
        blob = json.loads(export[1])
        blob["pgid"] = "9.9"
        got.append(_run_tool(p, base + ["--op", "import"],
                             stdin=json.dumps(blob)))
        got.append(_run_tool(p, base + ["--op", "remove", "--pgid", "2.3",
                                        "--oid", "obj"]))
        st = p.wal.WALStore(str(d))
        st.mount()
        outs[name] = (got, state(st))
    assert outs["ceph_tpu"] == outs["ceph_tpu_torch"]
    got, st = outs["ceph_tpu_torch"]
    assert json.loads(got[0][1]) == {"1.0": ["rbd_data.1"], "2.3": ["obj"]}
    assert base64.b64decode(json.loads(got[2][1])["data_b64"]) == \
        bytes(range(200))
    assert st["9.9"]["rbd_data.1"][0] == bytes(range(200))
    assert "obj" not in st["2.3"]


# -- racecheck, log, copytrack -----------------------------------------


def test_port_racecheck_reports_a_seeded_race():
    """Two threads write a ``guarded_by`` field without its lock: the
    port's racecheck (on the port's lockdep) reports it, ``ceph_tpu``'s
    records nothing."""
    import ceph_tpu.analysis.racecheck as ref_racecheck

    if not (port_racecheck.enabled() and port_lockdep.enabled()):
        pytest.skip("CEPH_TPU_RACECHECK and CEPH_TPU_LOCKDEP are off")
    lk = port_lockdep.make_lock("test::seeded")

    @port_racecheck.guarded_by("test::seeded", "count")
    class Counter:
        def __init__(self):
            self.count = 0

    c = Counter()
    port_racecheck.publish(c)
    ref_base = ref_racecheck.mark()
    with port_racecheck.trap() as got:
        with lk:
            c.count += 1  # guarded: clean

        def bump():
            c.count += 1  # unguarded, from another thread

        th = threading.Thread(target=bump)
        th.start()
        th.join(timeout=60)
        assert not th.is_alive()
        c.count += 1
    assert any("Counter.count" in v["message"] and v["kind"] == "lockset"
               for v in got), got
    assert ref_racecheck.mark() == ref_base
    assert "WALStore[os::wal]" in " ".join(
        port_racecheck.dump()["guarded_classes"])


def test_log_ring_and_copy_ledger():
    core = port_log.LogCore(max_recent=3, stream=io.StringIO())
    lg = port_log.SubsysLogger("wal", core)
    core.set_level("wal", 1)
    for i in range(5):
        lg.dout(i % 3, f"m{i}")
    lg.derr("bad")
    out = io.StringIO()
    assert core.dump_recent(out) == 3
    assert out.getvalue().splitlines()[-2].endswith("wal -1 : bad")
    assert core.stream.getvalue().count("\n") == 5  # levels 0, 1, 0, 1, -1
    from ceph_tpu.common import copytrack as ref_copytrack
    from ceph_tpu.common.perf_counters import \
        PerfCountersCollection as RefColl
    from ceph_tpu_torch.common.perf_counters import \
        PerfCountersCollection as PortColl

    dumps = []
    for ct, coll in ((ref_copytrack, RefColl()), (port_copytrack,
                                                  PortColl())):
        ct.book("store_txn", 4096, 2, coll=coll)
        ct.book_pc(ct.ledger(coll), "recv", 100)
        ct.book("send", 0, 0, coll=coll)
        dumps.append(coll.dump()["obs.copy"])
    assert dumps[0] == dumps[1]
    assert dumps[1]["bytes_copied"] == 4196
