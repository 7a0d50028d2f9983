"""MemStore — the in-RAM ObjectStore backend.

The port's copy of ``ceph_tpu/os/memstore.py``; it consults the port's
failpoints (``os.read_eio``, ``store.bit_rot``).  The role of
src/os/memstore/MemStore.{h,cc}: a dict-of-dicts store applying
transactions under one lock.  Ops are applied to a working copy of the
touched objects and swapped in only when every op succeeded, so a
failed op leaves the store untouched.

``export_state``/``import_state`` (and the enveloped
``export_blob``/``import_blob``) serialize the whole store.
"""

from __future__ import annotations

import errno
from typing import Dict, List, Optional

from ..analysis import faults
from ..analysis.lockdep import make_rlock
from ..common import copytrack, encoding
from .objectstore import (ObjectStore, Transaction, OP_CLONE, OP_MKCOLL,
                          OP_OMAP_CLEAR, OP_OMAP_RMKEYS,
                          OP_OMAP_SETKEYS, OP_REMOVE, OP_RMATTR,
                          OP_RMCOLL, OP_SETATTR, OP_TOUCH, OP_TRUNCATE,
                          OP_WRITE, OP_ZERO)


class _Object:
    __slots__ = ("data", "xattr", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattr: Dict[str, bytes] = {}
        self.omap: Dict[str, bytes] = {}

    def clone(self) -> "_Object":
        o = _Object()
        o.data = bytearray(self.data)
        o.xattr = dict(self.xattr)
        o.omap = dict(self.omap)
        return o


class TransactionError(Exception):
    pass


class MemStore(ObjectStore):
    def __init__(self, copy_coll=None):
        self._coll: Dict[str, Dict[str, _Object]] = {}
        self._lock = make_rlock("os::mem")
        # byte-copy ledger target: a mounting daemon passes its
        # Context's collection so store_txn bookings ride that
        # daemon's asok perf dump; library/test use books globally
        self._copy_pc = copytrack.ledger(copy_coll)

    # -- transaction application --------------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        with self._lock:  # RLock: spans prepare AND commit — atomic
            self.prepare_transaction(txn)()
        # copy ledger: each OP_WRITE materialises its payload into
        # the object's backing bytearray once (full replace or RMW
        # splice).  The WAL path books its own queue_transaction —
        # it calls prepare_transaction directly, never this method,
        # so the two sites can't double count.
        nbytes = sum(len(op[4]) for op in txn.ops
                     if op[0] == OP_WRITE)
        if nbytes:
            copytrack.book_pc(self._copy_pc, "store_txn", nbytes,
                              copies=1)

    def prepare_transaction(self, txn: Transaction):
        """Validate and stage a transaction without committing it;
        returns a cannot-fail commit callable that swaps the staged
        state in.  WAL stores journal between the two, so a journaled
        record is always applicable and a failed validation never
        journals.  The caller is responsible for serializing
        prepare→commit windows (WALStore holds its own lock across
        both); interleaved prepares would lose updates."""
        with self._lock:
            # lazy copy-on-touch: only the top-level dict is copied up
            # front; a collection's object dict is copied the first
            # time an op touches it (a shard write must not cost
            # O(total objects across all PGs))
            staged = dict(self._coll)
            copied: set = set()
            for op in txn.ops:
                self._apply(staged, copied, op)

        def commit():
            with self._lock:
                self._coll = staged

        return commit

    @staticmethod
    def _coll_for_write(staged, copied, cid: str):
        if cid not in staged:
            raise TransactionError(f"no collection {cid!r}")
        if cid not in copied:
            staged[cid] = dict(staged[cid])
            copied.add(cid)
        return staged[cid]

    def _obj(self, staged, copied, cid: str, oid: str,
             create: bool = False) -> _Object:
        objs = self._coll_for_write(staged, copied, cid)
        o = objs.get(oid)
        if o is None:
            if not create:
                raise TransactionError(f"no object {cid}/{oid}")
            o = _Object()
            objs[oid] = o
        else:
            # copy-on-write: staged holds shallow copies of the
            # collection dicts; objects mutate via private clones
            o = o.clone()
            objs[oid] = o
        return o

    def _apply(self, staged, copied, op) -> None:
        kind = op[0]
        if kind == OP_MKCOLL:
            _, cid = op
            if cid in staged:
                raise TransactionError(f"collection {cid!r} exists")
            staged[cid] = {}
            copied.add(cid)
        elif kind == OP_RMCOLL:
            _, cid = op
            if staged.get(cid):
                raise TransactionError(f"collection {cid!r} not empty")
            if cid not in staged:
                raise TransactionError(f"no collection {cid!r}")
            del staged[cid]
        elif kind == OP_TOUCH:
            _, cid, oid = op
            self._obj(staged, copied, cid, oid, create=True)
        elif kind == OP_WRITE:
            _, cid, oid, offset, data = op
            o = self._obj(staged, copied, cid, oid, create=True)
            if offset == 0 and len(o.data) <= len(data):
                # full replace (the data-path common case): one copy,
                # no zero-fill pass
                o.data = bytearray(data)
            else:
                end = offset + len(data)
                if len(o.data) < end:
                    o.data.extend(b"\0" * (end - len(o.data)))
                o.data[offset:end] = data
        elif kind == OP_ZERO:
            _, cid, oid, offset, length = op
            # extends past EOF like the reference's _zero-via-_write
            o = self._obj(staged, copied, cid, oid)
            end = offset + length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[offset:end] = b"\0" * (end - offset)
        elif kind == OP_TRUNCATE:
            _, cid, oid, size = op
            o = self._obj(staged, copied, cid, oid)
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif kind == OP_REMOVE:
            _, cid, oid = op
            if cid not in staged or oid not in staged[cid]:
                raise TransactionError(f"no object {cid}/{oid}")
            del self._coll_for_write(staged, copied, cid)[oid]
        elif kind == OP_CLONE:
            _, cid, src, dst = op
            o = self._obj(staged, copied, cid, src)
            self._coll_for_write(staged, copied, cid)[dst] = o.clone()
        elif kind == OP_SETATTR:
            _, cid, oid, key, value = op
            self._obj(staged, copied, cid, oid, create=True).xattr[key] = value
        elif kind == OP_RMATTR:
            _, cid, oid, key = op
            self._obj(staged, copied, cid, oid).xattr.pop(key, None)
        elif kind == OP_OMAP_SETKEYS:
            _, cid, oid, kv = op
            self._obj(staged, copied, cid, oid, create=True).omap.update(kv)
        elif kind == OP_OMAP_RMKEYS:
            _, cid, oid, keys = op
            o = self._obj(staged, copied, cid, oid)
            for k in keys:
                o.omap.pop(k, None)
        elif kind == OP_OMAP_CLEAR:
            _, cid, oid = op
            self._obj(staged, copied, cid, oid).omap.clear()
        else:
            raise TransactionError(f"unknown op {kind!r}")

    # -- reads --------------------------------------------------------
    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = -1) -> bytes:
        if faults.fires("os.read_eio"):
            # the filestore_debug_inject_read_err role: a bad sector
            # under an object — WALStore delegates reads here, so one
            # hook covers both store flavors
            raise OSError(errno.EIO,
                          f"injected read error: {cid}/{oid}")
        with self._lock:
            o = self._coll.get(cid, {}).get(oid)
            if o is None:
                raise KeyError(f"no object {cid}/{oid}")
            # the returned payload must stay valid after the lock
            # drops and later writes mutate o.data, so it cannot be a
            # view into the object
            if length < 0:
                out = bytes(o.data[offset:])  # copy-ok: read materialisation, survives later writes
            else:
                out = bytes(o.data[offset:offset + length])  # copy-ok: read materialisation, survives later writes
        if faults._ACTIVE and faults.fires("store.bit_rot"):
            # silent media corruption: the store returns success with
            # one flipped byte — only crc verification above can tell
            out = faults.flip_byte(out)
        return out

    def stat(self, cid: str, oid: str) -> Optional[Dict]:
        with self._lock:
            o = self._coll.get(cid, {}).get(oid)
            if o is None:
                return None
            return {"size": len(o.data), "xattrs": len(o.xattr),
                    "omap_keys": len(o.omap)}

    def getattr(self, cid: str, oid: str, key: str) -> Optional[bytes]:
        with self._lock:
            o = self._coll.get(cid, {}).get(oid)
            return None if o is None else o.xattr.get(key)

    def omap_get(self, cid: str, oid: str) -> Dict[str, bytes]:
        with self._lock:
            o = self._coll.get(cid, {}).get(oid)
            return dict(o.omap) if o is not None else {}

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._coll)

    def list_objects(self, cid: str) -> List[str]:
        with self._lock:
            return sorted(self._coll.get(cid, {}))

    def collection_exists(self, cid: str) -> bool:
        with self._lock:
            return cid in self._coll

    # -- checkpoint/restart -------------------------------------------
    def export_state(self) -> Dict:
        with self._lock:
            return {
                cid: {oid: {"data": bytes(o.data).hex(),  # copy-ok: checkpoint export, off the data path
                            "xattr": {k: v.hex()
                                      for k, v in o.xattr.items()},
                            "omap": {k: v.hex()
                                     for k, v in o.omap.items()}}
                      for oid, o in objs.items()}
                for cid, objs in self._coll.items()
            }

    # the wire/disk form of a full-store export (corpus type
    # os.memstore_export): the raw hex-dict state, enveloped
    EXPORT_V = 1

    def export_blob(self) -> str:
        # the collections live under their own key so a future writer
        # can add sibling fields old readers skip (DECODE_FINISH)
        return encoding.encode({"colls": self.export_state()},
                               self.EXPORT_V, 1)

    @classmethod
    def import_blob(cls, blob) -> "MemStore":
        """Lenient: pre-envelope raw-dict exports (writer v0 — the
        bare collections dict) still decode — archived store dumps
        stay importable."""
        v, data = encoding.decode_any(blob, supported=cls.EXPORT_V,
                                      struct="os.memstore_export")
        try:
            state = data if v < 1 else data["colls"]
            return cls.import_state(state)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            raise encoding.MalformedInput(
                f"os.memstore_export v{v}: bad payload: {e!r}")

    @classmethod
    def import_state(cls, state: Dict) -> "MemStore":
        st = cls()
        for cid, objs in state.items():
            st._coll[cid] = {}
            for oid, od in objs.items():
                o = _Object()
                o.data = bytearray(bytes.fromhex(od["data"]))
                o.xattr = {k: bytes.fromhex(v)
                           for k, v in od["xattr"].items()}
                o.omap = {k: bytes.fromhex(v)
                          for k, v in od["omap"].items()}
                st._coll[cid][oid] = o
        return st
