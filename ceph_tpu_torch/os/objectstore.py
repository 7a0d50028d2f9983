"""ObjectStore API — transactional object persistence.

The port's copy of ``ceph_tpu/os/objectstore.py``.  The role of
src/os/ObjectStore.h and src/os/Transaction.{h,cc}: a store holds
collections (one per PG in the OSD); a collection holds objects; an
object has byte data, xattrs and an omap (ordered key-value).  All
mutation happens through a ``Transaction``, an ordered op list applied
atomically by ``queue_transaction``.  Ops are plain tuples, so a
transaction encodes as the journal's record (``common.bincode``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

# op codes (Transaction.h enum)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_CLONE = "clone"
OP_SETATTR = "setattr"
OP_RMATTR = "rmattr"
OP_OMAP_SETKEYS = "omap_setkeys"
OP_OMAP_RMKEYS = "omap_rmkeys"
OP_OMAP_CLEAR = "omap_clear"
OP_MKCOLL = "mkcoll"
OP_RMCOLL = "rmcoll"


class Transaction:
    """An ordered, atomically-applied op list."""

    def __init__(self):
        self.ops: List[Tuple] = []

    # -- collection ops ----------------------------------------------
    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_MKCOLL, cid))
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append((OP_RMCOLL, cid))
        return self

    # -- object ops ---------------------------------------------------
    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_TOUCH, cid, oid))
        return self

    def write(self, cid: str, oid: str, offset: int,
              data: bytes) -> "Transaction":
        """``data`` may be any buffer-protocol object (bytes, or a
        memoryview into a pooled recv segment) — it is staged AS IS,
        zero-copy.  The contract is the reference's bufferlist one:
        the buffer must stay valid until queue_transaction returns
        (both stores materialise into their own image inside it, and
        every caller queues within the handler that owns the view)."""
        self.ops.append((OP_WRITE, cid, oid, offset, data))
        return self

    def zero(self, cid: str, oid: str, offset: int,
             length: int) -> "Transaction":
        self.ops.append((OP_ZERO, cid, oid, offset, length))
        return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append((OP_TRUNCATE, cid, oid, size))
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_REMOVE, cid, oid))
        return self

    def clone(self, cid: str, src: str, dst: str) -> "Transaction":
        self.ops.append((OP_CLONE, cid, src, dst))
        return self

    def setattr(self, cid: str, oid: str, key: str,
                value: bytes) -> "Transaction":
        # copy-ok: attr values are tiny metadata (version stamps) the
        # store retains by reference past the caller's buffer lifetime
        self.ops.append((OP_SETATTR, cid, oid, key, bytes(value)))
        return self

    def rmattr(self, cid: str, oid: str, key: str) -> "Transaction":
        self.ops.append((OP_RMATTR, cid, oid, key))
        return self

    def omap_setkeys(self, cid: str, oid: str,
                     kv: Dict[str, bytes]) -> "Transaction":
        # omap values are small keys/records the store retains by
        # reference past the caller's buffer lifetime
        self.ops.append((OP_OMAP_SETKEYS, cid, oid,
                         {k: bytes(v) for k, v in kv.items()}))  # copy-ok: small omap records, retained by reference
        return self

    def omap_rmkeys(self, cid: str, oid: str,
                    keys: Iterable[str]) -> "Transaction":
        self.ops.append((OP_OMAP_RMKEYS, cid, oid, list(keys)))
        return self

    def omap_clear(self, cid: str, oid: str) -> "Transaction":
        self.ops.append((OP_OMAP_CLEAR, cid, oid))
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    def __len__(self) -> int:
        return len(self.ops)


class ObjectStore:
    """The abstract store (ObjectStore.h)."""

    def mount(self) -> None: ...

    def umount(self) -> None: ...

    def mkfs(self) -> None: ...

    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    # reads (never transactional, ObjectStore.h read side)
    def read(self, cid: str, oid: str, offset: int = 0,
             length: int = -1) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: str) -> Optional[Dict]:
        raise NotImplementedError

    def getattr(self, cid: str, oid: str, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def list_collections(self) -> List[str]:
        raise NotImplementedError

    def list_objects(self, cid: str) -> List[str]:
        raise NotImplementedError

    def collection_exists(self, cid: str) -> bool:
        raise NotImplementedError
