"""Wire-format conformance — the ceph-dencoder / object-corpus role.

The reference proves every wire/disk structure with three machines:
``ceph-dencoder`` (encode/decode any registered type from the command
line), the ceph-object-corpus (committed encodings of every struct at
every historical version, byte-compared and back-decoded each build),
and ``test/encoding/readable.sh`` (old blobs must stay readable).
This module is all three for this framework: a declarative registry of
every wire/disk type in the system — messenger frames (each typed
family), OSDMap full/crush binary encodes, Incremental deltas, crush
JSON, WALStore records and compressed checkpoints, cephx keyring and
tickets, MemStore exports, PG log entries, rbd image headers, and the
monitor's epoch-store payload — each entry carrying its
struct_v/compat_v, a deterministic example factory, and its
encode/decode pair.

For every entry ``check()`` machine-proves five properties:

1. round-trip identity   decode(encode(x)) == x
2. determinism           encode is byte-stable (twice from fresh
                         examples, and re-encode of the decoded form)
3. forward-compat        a v+1 writer's unknown fields are skipped,
                         per the DECODE_START/DECODE_FINISH contract
4. compat-floor refusal  a blob whose compat exceeds this reader is
                         refused with a typed ``MalformedInput`` —
                         never a hang, assert, or raw KeyError
5. mutation robustness   truncation, length-word and flags tampering,
                         bit flips, undecodable bytes all fail CLEAN
                         (MalformedInput or a benign decode — no
                         other exception class may escape)

The port's copy of ``ceph_tpu/analysis/wirecheck.py``, over the port's
messenger, auth, maps, stores, PG log, monitor and image.  Its examples
encode byte-equal to ``ceph_tpu``'s and to the committed golden corpus
(``tests/corpus/encodings/<type>/<struct_v>/``), which it reads and
never writes; ``tests/test_torch_wirecheck.py`` holds it there and runs
all five properties per entry.  ``ceph_cli dencoder`` is the
command-line surface; ``covered_classes()`` and ``frame_type_names()``
name what the registry proves.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..common.encoding import MalformedInput

# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@dataclass
class WireType:
    """One registered wire/disk format."""

    name: str
    kind: str                 # "json" | "bincode" | "frame" | "custom"
    struct_v: int
    compat_v: int
    factory: Callable[[], Any]
    encode: Callable[[Any], bytes]
    decode: Callable[[bytes], Any]
    # comparable form of a decoded/example object (to_dict and kin)
    extract: Callable[[Any], Any] = lambda o: o
    # craft a blob demanding a FUTURE reader (property 4) / written by
    # a v+1 writer with extra fields (property 3); kind defaults below
    forge_compat: Optional[Callable[[bytes], bytes]] = None
    forge_forward: Optional[Callable[[bytes], bytes]] = None
    # encode(decode(blob)) == blob is additionally enforced when set
    reencode: bool = True
    # source class names this entry proves (lint WIRE002)
    covers: Tuple[str, ...] = ()
    # frame-type literals this entry owns (lint WIRE003)
    frame_types: Tuple[str, ...] = ()
    # legacy pre-envelope blobs (writer v0) decode too
    legacy: bool = False


_REGISTRY: Optional[Dict[str, WireType]] = None


def _to_bytes(blob) -> bytes:
    return blob.encode() if isinstance(blob, str) else bytes(blob)


# -- default forges by codec kind -------------------------------------------

def _json_forge_compat(e: WireType, blob: bytes) -> bytes:
    env = json.loads(blob)
    env["v"] = env["compat"] = e.struct_v + 1
    return json.dumps(env).encode()


def _json_forge_forward(e: WireType, blob: bytes) -> bytes:
    env = json.loads(blob)
    env["v"] = e.struct_v + 1
    if isinstance(env.get("data"), dict):
        env["data"]["__added_in_v_next__"] = {"unknown": True}
    return json.dumps(env).encode()


def _bin_forge_compat(e: WireType, blob: bytes) -> bytes:
    # bincode envelope at offset 0: u8 struct_v, u8 compat_v, u32 len
    return bytes([blob[0] + 1, blob[1] + 1]) + blob[2:]


def _bin_forge_forward(e: WireType, blob: bytes) -> bytes:
    # a v+1 writer appended 4 unknown bytes inside the envelope: bump
    # struct_v, splice at the envelope end, patch the length word —
    # DECODE_FINISH must skip them
    (ln,) = struct.unpack_from("<I", blob, 2)
    end = 6 + ln
    return (bytes([blob[0] + 1]) + blob[1:2]
            + struct.pack("<I", ln + 4) + blob[6:end]
            + b"\x00\x01\x02\x03" + blob[end:])


def _frame_forge_compat(e: WireType, blob: bytes) -> bytes:
    # the frame's compat floor is its version byte
    return bytes([blob[0] + 1]) + blob[1:]


# ---------------------------------------------------------------------------
# example factories (all deterministic — the corpus byte-compares them)
# ---------------------------------------------------------------------------

def _mini_map():
    from ..crush.wrapper import CrushWrapper
    from ..osdmap.osdmap import OSDMap, PgPool

    w = CrushWrapper()
    for d in range(4):
        w.insert_item(d, 0x10000, f"osd.{d}",
                      {"host": f"h{d % 2}", "root": "default"})
    rid = w.add_simple_rule("r", "default", "host", "", "firstn")
    m = OSDMap(w.crush)
    for d in range(4):
        m.add_osd(d)
    m.pools[1] = PgPool(size=2, pg_num=8, crush_rule=rid)
    m.pg_upmap[(1, 1)] = [1, 2]
    m.pg_upmap_items[(1, 2)] = [(0, 3)]
    m.pg_temp[(1, 3)] = [2, 0]
    m.primary_temp[(1, 3)] = 2
    m.set_primary_affinity(1, 0x8000)
    m.epoch = 7
    return m


def _ex_incremental():
    from ..osdmap.incremental import Incremental
    from ..osdmap.osdmap import PgPool

    inc = Incremental(epoch=8)
    inc.new_max_osd = 5
    inc.new_pools = {2: PgPool(size=3, pg_num=4).to_dict()}
    inc.old_pools = [3]
    inc.new_state = {0: 2}            # XOR
    inc.new_weight = {1: 0x8000}
    inc.new_primary_affinity = {2: 0x4000}
    inc.new_pg_upmap = {(1, 1): [0, 1]}
    inc.old_pg_upmap = [(1, 2)]
    inc.new_pg_upmap_items = {(1, 3): [(0, 2)]}
    inc.old_pg_upmap_items = [(1, 4)]
    inc.new_pg_temp = {(1, 5): [1, 0]}
    inc.new_primary_temp = {(1, 5): 1}
    return inc


def _ex_epoch_payload():
    m = _mini_map()
    return {"epoch": m.epoch, "map": m.to_dict(),
            "osd_addrs": {"0": ["127.0.0.1", 6800],
                          "1": ["127.0.0.1", 6801]},
            "ec_profiles": {"ec22": {"k": "2", "m": "2",
                                     "plugin": "jerasure"}}}


def _ex_txn_ops():
    from ..os.objectstore import (OP_MKCOLL, OP_OMAP_SETKEYS,
                                  OP_SETATTR, OP_WRITE)

    return [
        (OP_MKCOLL, "pg-1.3"),
        (OP_WRITE, "pg-1.3", "obj-1.s2", 0, b"\x00\x01\x02\x03" * 4),
        (OP_SETATTR, "pg-1.3", "obj-1.s2", "v",
         b"000000000007.00000000000000000001"),
        (OP_OMAP_SETKEYS, "pg-1.3", "pglog",
         {"000000000007.00000000000000000001|2": b"{}"}),
    ]


def _ex_memstore():
    from ..os.memstore import MemStore, _Object

    st = MemStore()
    o = _Object()
    o.data = bytearray(b"\x01\x02\x03\x04payload")
    o.xattr = {"v": b"000000000007.00000000000000000001",
               "size": b"11"}
    o.omap = {"k1": b"v1"}
    st._coll = {"pg-1.3": {"obj-1.s0": o}}
    return st


def _ex_ckpt_state():
    from ..os.memstore import _Object

    o1 = _Object()
    o1.data = bytearray(b"alpha" * 8)
    o1.xattr = {"crc": b"12345"}
    o2 = _Object()
    o2.omap = {"000000000003.00000000000000000001|d": b"{}"}
    return (9, {"pg-1.0": {"obj-a.s1": o1, "pglog": o2}})


def _colls_plain(colls) -> Dict:
    return {cid: {oid: (bytes(o.data), dict(o.xattr), dict(o.omap))
                  for oid, o in objs.items()}
            for cid, objs in colls.items()}


def _ex_pg_log_entry():
    from ..services.pg_log import PgLogEntry

    return PgLogEntry(op="write", oid="obj-1",
                      v="000000000007.00000000000000000001",
                      shard=2, size=4096)


def _ex_image_header():
    return {"size": 1 << 20, "stripe_unit": 4096, "stripe_count": 4,
            "object_size": 1 << 16,
            "snaps": [{"name": "s1", "size": 1 << 20,
                       "protected": True}],
            "parent": None,
            "children": [{"name": "clone-1", "snap": "s1"}]}


_FIXED_KEY = bytes(range(32))
_FIXED_NOW = 1_700_000_000.0


def _ex_keyring():
    from ..msg.auth import Keyring

    return Keyring(_FIXED_KEY)


def _ex_ticket():
    return _ex_keyring().issue_ticket("client.admin", lifetime=3600.0,
                                      now=_FIXED_NOW)


def _ex_frame_op():
    return {"type": "shard_write", "tid": "tid-0001",
            "frm": "client.x", "_s": 5, "_sess": "sess0001",
            "pool": 1, "ps": 3, "oid": "obj-1", "shard": 2,
            "v": "000000000007.00000000000000000001",
            "size": 32, "data": b"\x00\x01\x02\x03" * 8,
            # a LITERAL sentinel-shaped value: must ride the escape
            # path and come back verbatim
            "odd": {"__frame_blob__": 0}}


def _ex_frame_hello():
    return {"type": "__hello__", "tid": "tid-0002", "frm": "osd.1",
            "sess": "sess0001"}


def _ex_frame_ack():
    return {"type": "__ack__", "sess": "sess0001", "in_seq": 7,
            "addr": ["127.0.0.1", 6789]}


def _ex_frame_reply():
    return {"type": "__reply__", "tid": "tid-0001",
            "payload": {"ok": True, "epoch": 7}}


def _ex_frame_map_push():
    # a control segment big enough to cross the zlib threshold, so
    # the compressed-frame path is corpus-pinned and mutation-tested
    return {"type": "map_full", "frm": "mon",
            "epoch": 7, "filler": ["x" * 64] * 512,
            "osd_addrs": {"0": ["127.0.0.1", 6800]}}


def _frame_encode(msg: Dict) -> bytes:
    from ..msg.messenger import encode_frame

    return encode_frame(msg)


def _frame_decode(payload: bytes) -> Dict:
    from ..msg.messenger import _restore_blobs, decode_frame

    msg, blobs = decode_frame(payload)
    return _restore_blobs(msg, blobs)


def _frame_forward(example_factory):
    """A same-version peer with a NEWER application schema added an
    unknown control field — handlers must ignore it."""
    def forge(_blob: bytes) -> bytes:
        msg = dict(example_factory())
        msg["__added_in_v_next__"] = {"unknown": True}
        return _frame_encode(msg)
    return forge


# -- WAL forges (header crc must be rebuilt around the patched body) --

def _wal_rec_forge(inner):
    def forge(blob: bytes) -> bytes:
        from ..os import wal_store as W

        seq, payload, _end = W.decode_record(blob)
        p2 = inner(payload)
        return W._HDR.pack(W._MAGIC, seq, len(p2),
                           W._crc32c(p2)) + p2
    return forge


def _ckpt_forge(inner):
    def forge(blob: bytes) -> bytes:
        from ..common.compressor import Compressor
        from ..os import wal_store as W

        magic, seq, ln, _crc = W._HDR.unpack_from(blob)
        body = W._unpack_body(magic, blob[W._HDR.size:W._HDR.size + ln])
        body = inner(body)
        comp = Compressor("zlib") if magic == W._MAGIC_Z else None
        magic2, packed = W._pack_body(body, comp)
        return W._HDR.pack(magic2, seq, len(packed),
                           W._crc32c(packed)) + packed
    return forge


def _bin_patch_compat(body: bytes) -> bytes:
    return bytes([body[0] + 1, body[1] + 1]) + body[2:]


def _bin_patch_forward(body: bytes) -> bytes:
    (ln,) = struct.unpack_from("<I", body, 2)
    end = 6 + ln
    return (bytes([body[0] + 1]) + body[1:2]
            + struct.pack("<I", ln + 4) + body[6:end]
            + b"\x00\x01\x02\x03" + body[end:])


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def _build() -> Dict[str, WireType]:
    from ..common.bincode import Decoder, Encoder, decode_txn, encode_txn
    from ..common.compressor import Compressor
    from ..crush.map import CrushMap
    from ..msg import auth
    from ..os import wal_store as W
    from ..os.memstore import MemStore
    from ..osdmap import bincode_maps as B
    from ..osdmap.incremental import Incremental
    from ..osdmap.osdmap import PgPool
    from ..services import image, monitor
    from ..services.pg_log import PgLogEntry

    reg: Dict[str, WireType] = {}

    def add(e: WireType) -> None:
        if e.forge_compat is None:
            e.forge_compat = {
                "json": lambda b, e=e: _json_forge_compat(e, b),
                "bincode": lambda b, e=e: _bin_forge_compat(e, b),
                "frame": lambda b, e=e: _frame_forge_compat(e, b),
            }.get(e.kind)
        if e.forge_forward is None:
            e.forge_forward = {
                "json": lambda b, e=e: _json_forge_forward(e, b),
                "bincode": lambda b, e=e: _bin_forge_forward(e, b),
            }.get(e.kind)
        reg[e.name] = e

    # -- messenger frame families ------------------------------------
    from ..msg.messenger import _FRAME_V

    for name, fac, ftypes in (
            ("msg.frame", _ex_frame_op, ()),
            ("msg.frame.hello", _ex_frame_hello, ("__hello__",)),
            ("msg.frame.ack", _ex_frame_ack, ("__ack__",)),
            ("msg.frame.reply", _ex_frame_reply, ("__reply__",)),
            ("msg.frame.map_push", _ex_frame_map_push, ())):
        add(WireType(
            name=name, kind="frame", struct_v=_FRAME_V,
            compat_v=_FRAME_V, factory=fac,
            encode=_frame_encode, decode=_frame_decode,
            forge_forward=_frame_forward(fac),
            frame_types=ftypes))

    # -- auth ----------------------------------------------------------
    add(WireType(
        name="msg.auth.keyring", kind="json",
        struct_v=auth.KEYRING_V, compat_v=1,
        factory=_ex_keyring,
        encode=lambda k: k.to_wire().encode(),
        decode=auth.Keyring.from_wire,
        extract=lambda k: k.to_hex(),
        covers=("Keyring",)))
    add(WireType(
        name="msg.auth.ticket", kind="json",
        struct_v=auth.TICKET_V, compat_v=1,
        factory=_ex_ticket,
        encode=lambda t: auth.encode_ticket(t).encode(),
        decode=auth.decode_ticket, legacy=True))

    # -- osdmap family -------------------------------------------------
    add(WireType(
        name="osdmap.full", kind="bincode", struct_v=1, compat_v=1,
        factory=_mini_map, encode=B.osdmap_to_bytes,
        decode=B.osdmap_from_bytes,
        extract=lambda m: m.to_dict(), covers=("OSDMap",)))
    add(WireType(
        name="osdmap.crush", kind="bincode", struct_v=1, compat_v=1,
        factory=lambda: _mini_map().crush, encode=B.crush_to_bytes,
        decode=B.crush_from_bytes, extract=lambda m: m.to_dict()))
    add(WireType(
        name="osdmap.pg_pool", kind="json",
        struct_v=PgPool.STRUCT_V, compat_v=PgPool.COMPAT_V,
        factory=lambda: PgPool(pool_type=3, size=4, min_size=3,
                               pg_num=16, crush_rule=1,
                               erasure_code_profile="ec22"),
        encode=lambda p: p.encode_versioned().encode(),
        decode=PgPool.decode_versioned,
        extract=lambda p: p.to_dict(), covers=("PgPool",)))
    add(WireType(
        name="osdmap.incremental", kind="json",
        struct_v=Incremental.STRUCT_V, compat_v=Incremental.COMPAT_V,
        factory=_ex_incremental,
        encode=lambda i: i.encode_versioned().encode(),
        decode=Incremental.decode_versioned,
        extract=lambda i: i.to_dict(), covers=("Incremental",)))
    add(WireType(
        name="crush.map_json", kind="json",
        struct_v=CrushMap.STRUCT_V, compat_v=CrushMap.COMPAT_V,
        factory=lambda: _mini_map().crush,
        encode=lambda m: m.to_json().encode(),
        decode=CrushMap.from_json,
        extract=lambda m: m.to_dict(), legacy=True))

    # -- object store family -------------------------------------------
    def _txn_encode(ops) -> bytes:
        enc = Encoder()
        encode_txn(ops, enc)
        return enc.bytes()

    add(WireType(
        name="os.txn", kind="bincode", struct_v=1, compat_v=1,
        factory=_ex_txn_ops, encode=_txn_encode,
        decode=lambda b: decode_txn(Decoder(b, struct_name="os.txn"))))
    add(WireType(
        name="os.wal_record", kind="custom", struct_v=1, compat_v=1,
        factory=lambda: (5, _ex_txn_ops()),
        encode=lambda t: W.encode_record(t[0], t[1]),
        decode=lambda b: (lambda s, p, _e:
                          (s, decode_txn(Decoder(
                              p, struct_name="os.txn"))))(
                              *W.decode_record(b)),
        forge_compat=_wal_rec_forge(_bin_patch_compat),
        forge_forward=_wal_rec_forge(_bin_patch_forward)))
    add(WireType(
        name="os.wal_checkpoint", kind="custom",
        struct_v=W.CHECKPOINT_V, compat_v=1,
        factory=_ex_ckpt_state,
        encode=lambda t: W.encode_checkpoint(t[0], t[1],
                                             Compressor("zlib")),
        decode=W.decode_checkpoint,
        extract=lambda t: (t[0], _colls_plain(t[1])),
        forge_compat=_ckpt_forge(_bin_patch_compat),
        forge_forward=_ckpt_forge(_bin_patch_forward)))
    add(WireType(
        name="os.memstore_export", kind="json",
        struct_v=MemStore.EXPORT_V, compat_v=1,
        factory=_ex_memstore,
        encode=lambda st: st.export_blob().encode(),
        decode=MemStore.import_blob,
        extract=lambda st: st.export_state(),
        covers=("MemStore",), legacy=True))

    # -- services ------------------------------------------------------
    add(WireType(
        name="osd.pg_log_entry", kind="json",
        struct_v=PgLogEntry.STRUCT_V, compat_v=PgLogEntry.COMPAT_V,
        factory=_ex_pg_log_entry,
        encode=lambda e: e.encode_blob(),
        decode=PgLogEntry.decode_blob,
        extract=lambda e: e.to_dict(),
        covers=("PgLogEntry",), legacy=True))
    add(WireType(
        name="rbd.image_header", kind="json",
        struct_v=image.HEADER_V, compat_v=1,
        factory=_ex_image_header,
        encode=image.encode_header, decode=image.decode_header,
        legacy=True))
    add(WireType(
        name="mon.epoch_payload", kind="json",
        struct_v=monitor.EPOCH_PAYLOAD_V, compat_v=1,
        factory=_ex_epoch_payload,
        encode=lambda p: monitor.encode_epoch_payload(p).encode(),
        decode=monitor.decode_epoch_payload,
        # the payload is built from to_dict forms holding tuples;
        # JSON canonicalizes them to lists — compare in wire shape
        extract=lambda p: json.loads(json.dumps(p)),
        legacy=True))

    return reg


def _registry() -> Dict[str, WireType]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _build()
    return _REGISTRY


def entries() -> List[WireType]:
    return [(_registry())[k] for k in sorted(_registry())]


def get(name: str) -> WireType:
    reg = _registry()
    if name not in reg:
        raise KeyError(f"no wire type {name!r}; have {sorted(reg)}")
    return reg[name]


def registered_names() -> List[str]:
    return sorted(_registry())


def covered_classes() -> set:
    """Class names whose wire form a registry entry proves — the
    WIRE002 ground truth."""
    out = set()
    for e in _registry().values():
        out.update(e.covers)
    return out


def frame_type_names() -> set:
    """Frame-type literals owned by a registry entry — the WIRE003
    ground truth."""
    out = set()
    for e in _registry().values():
        out.update(e.frame_types)
    return out


# ---------------------------------------------------------------------------
# the five-property checker
# ---------------------------------------------------------------------------

def _forward_ok(known, got) -> bool:
    """Forward-compat equality: every field THIS reader knows must
    round-trip; fields a future writer added may ride along in
    free-dict payloads."""
    if isinstance(known, dict) and isinstance(got, dict):
        return all(k in got and got[k] == v for k, v in known.items())
    return known == got


def _mutations(e: WireType, blob: bytes):
    """The corruption battery: truncations, bit flips at structural
    offsets, length-word bombs, pure garbage."""
    n = len(blob)
    yield b""
    yield blob[:1]
    yield blob[:n // 3]
    yield blob[:max(0, n - 1)]
    for pos in sorted({0, 1, 2, 5, n // 2, max(0, n - 4),
                       max(0, n - 1)}):
        if pos < n:
            b = bytearray(blob)
            b[pos] ^= 0xFF
            yield bytes(b)
    yield b"\xff" * 64
    yield bytes(range(256))
    if e.kind in ("frame", "bincode") and n >= 6:
        # forge the inner length word to claim ~4 GiB: must be refused
        # by bounds checks, never allocated or walked off the end
        b = bytearray(blob)
        b[2:6] = struct.pack("<I", 0xFFFFFFF0)
        yield bytes(b)


def check(e: WireType) -> List[str]:
    """Run all five conformance properties; returns failure strings
    (empty = conformant)."""
    fails: List[str] = []
    try:
        a, b = e.factory(), e.factory()
        blob = _to_bytes(e.encode(a))
    except Exception as ex:  # pragma: no cover - registration bug
        return [f"example/encode failed: {ex!r}"]

    # 1. round-trip identity
    try:
        got = e.decode(blob)
        if e.extract(got) != e.extract(a):
            fails.append("roundtrip: decoded object differs from "
                         "the example")
    except Exception as ex:
        fails.append(f"roundtrip: decode failed: {ex!r}")

    # 2. byte-level determinism
    if _to_bytes(e.encode(b)) != blob:
        fails.append("determinism: two encodes of fresh examples "
                     "differ")
    if e.reencode:
        try:
            if _to_bytes(e.encode(e.decode(blob))) != blob:
                fails.append("determinism: re-encode of the decoded "
                             "form differs")
        except Exception as ex:
            fails.append(f"determinism: re-encode failed: {ex!r}")

    # 3. forward-compat (unknown v+1 fields are skipped)
    if e.forge_forward is not None:
        try:
            fwd = e.forge_forward(blob)
            got = e.decode(fwd)
            if not _forward_ok(e.extract(a), e.extract(got)):
                fails.append("forward-compat: known fields did not "
                             "survive a v+1 blob")
        except Exception as ex:
            fails.append(f"forward-compat: v+1 blob refused: {ex!r}")

    # 4. compat-floor refusal, typed
    if e.forge_compat is not None:
        try:
            e.decode(e.forge_compat(blob))
            fails.append("compat-floor: a future-compat blob decoded "
                         "instead of being refused")
        except MalformedInput:
            pass
        except Exception as ex:
            fails.append(f"compat-floor: refusal is "
                         f"{type(ex).__name__}, not MalformedInput: "
                         f"{ex!r}")

    # 5. mutation robustness: every corruption fails clean
    for i, mut in enumerate(_mutations(e, blob)):
        try:
            e.decode(mut)
        except MalformedInput:
            pass
        except Exception as ex:
            fails.append(
                f"mutation[{i}] ({len(mut)}B): unclean failure "
                f"{type(ex).__name__}: {ex!r}")
    return fails


def check_all() -> Dict[str, List[str]]:
    """name -> failures for every registered type (the dencoder
    self-test / CI gate)."""
    return {e.name: check(e) for e in entries()}
