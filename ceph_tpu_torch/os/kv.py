"""KeyValueDB — the src/kv wrapper seam.

The port's copy of ``ceph_tpu/os/kv.py``.  The reference wraps RocksDB
behind ``KeyValueDB`` (get/set/rm by (prefix, key), iterators, atomic
transactions); the monitor rides it.  Here the same interface runs on
an ObjectStore collection (``kv``): each prefix is an object and its
keys live in the object's omap, so a ``KVTransaction`` is one store
transaction.  Any store with ``omap_get``/``collection_exists`` serves,
a ``WALStore`` included.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from .memstore import MemStore
from .objectstore import Transaction

_CID = "kv"


class KVTransaction:
    def __init__(self):
        self.ops: List[Tuple[str, str, str, Optional[bytes]]] = []

    def set(self, prefix: str, key: str,
            value: bytes) -> "KVTransaction":
        # copy-ok: KV values are small metadata records the store
        # retains by reference past the caller's buffer lifetime
        self.ops.append(("set", prefix, key, bytes(value)))
        return self

    def rmkey(self, prefix: str, key: str) -> "KVTransaction":
        self.ops.append(("rm", prefix, key, None))
        return self

    def rmkeys_by_prefix(self, prefix: str) -> "KVTransaction":
        self.ops.append(("rmprefix", prefix, "", None))
        return self


class KeyValueDB:
    def __init__(self, store: Optional[MemStore] = None):
        self.store = store or MemStore()
        if not self.store.collection_exists(_CID):
            self.store.queue_transaction(
                Transaction().create_collection(_CID))

    def submit_transaction(self, t: KVTransaction) -> None:
        txn = Transaction()
        for op, prefix, key, value in t.ops:
            if op == "set":
                txn.omap_setkeys(_CID, prefix, {key: value})
            elif op == "rm":
                txn.touch(_CID, prefix)
                txn.omap_rmkeys(_CID, prefix, [key])
            elif op == "rmprefix":
                txn.touch(_CID, prefix)
                txn.omap_clear(_CID, prefix)
        self.store.queue_transaction(txn)

    def get(self, prefix: str, key: str) -> Optional[bytes]:
        return self.store.omap_get(_CID, prefix).get(key)

    def get_by_prefix(self, prefix: str) -> Dict[str, bytes]:
        return dict(self.store.omap_get(_CID, prefix))

    def iterator(self, prefix: str) -> Iterator[Tuple[str, bytes]]:
        return iter(sorted(self.store.omap_get(_CID, prefix).items()))
