"""WALStore — the crash-consistent disk-backed ObjectStore.

The port's copy of ``ceph_tpu/os/wal_store.py``: the same record and
checkpoint bytes, so a directory written by one package mounts in the
other.  It consults the port's failpoints (``os.torn_append``,
``os.fsync_eio``) and its crc32c is the port's native slicing-by-8
(``ec.stripe.crc32c``).

The BlueStore role (src/os/bluestore/BlueStore.cc WAL and deferred
writes, the src/os/ObjectStore.h atomicity contract): state lives in
RAM (a MemStore twin); durability comes from a write-ahead log plus
checkpoints:

  queue_transaction:  encode and stage in memory (an invalid txn never
                      journals) -> append the WAL record -> fsync (the
                      ack point, shared by a group of concurrent
                      writers) -> the staged state becomes visible
  checkpoint:         snapshot the state to a temp file -> fsync ->
                      atomic rename over ``checkpoint`` -> truncate WAL
  mount:              load the checkpoint, replay WAL records with seq
                      above the checkpoint's, stopping at the first
                      torn or corrupt record (a kill -9 mid-append
                      leaves a torn tail; everything before it was
                      acked and survives)

Record format (binary, little-endian):
  magic u32 | seq u64 | len u32 | crc32c u32 | payload(len)
payload = the bincode-encoded Transaction op list.
"""

from __future__ import annotations

import errno
import os
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis import faults
from ..analysis.lockdep import make_lock, make_rlock
from ..analysis.racecheck import guarded_by
from ..common import copytrack
from ..common.bincode import (DecodeError, Decoder, Encoder, decode_txn,
                              encode_txn)
from ..common.encoding import MalformedInput
from ..common.log import getLogger
from ..common.perf_counters import collection
from .memstore import MemStore, _Object
from .objectstore import ObjectStore, Transaction

# process-global WAL metrics (every in-process store shares them;
# daemons' `perf dump` merges the global collection, the ec.engine
# pattern): txn count, shared fsyncs, and the group-size histogram —
# the depth-1-regression canary the aio smoke test gates on
_pc = collection().create("os.wal")
for _k in ("txns", "group_commits"):
    _pc.add_u64_counter(_k)
_pc.add_time("group_commit_time")
_pc.add_histogram("wal_group_size", min_value=1)

_MAGIC = 0x57414C31   # "WAL1": raw body
_MAGIC_Z = 0x57414C5A  # "WALZ": compressed body (compressor name
#                        prefixed to the payload, length-prefixed)
_HDR = struct.Struct("<IQII")

CHECKPOINT_V = 1  # struct_v of the checkpoint's bincode envelope


def _pack_body(body: bytes, comp) -> Tuple[int, bytes]:
    """(magic, on-disk body): checkpoints/records run through the
    compressor registry (the BlueStore per-pool compression role,
    src/compressor) when one is configured."""
    if comp is None or comp.name == "none":
        return _MAGIC, body
    packed = comp.compress(body)
    tag = comp.name.encode()
    # copy-ok: one-byte compressor-tag length header, not payload
    return _MAGIC_Z, bytes([len(tag)]) + tag + packed


def _unpack_body(magic: int, body: bytes) -> bytes:
    """Raises MalformedInput for an unknown compressor tag or a body
    that fails to decompress — a store written with a codec this build
    lacks (or bit-rotted in the compressed region) must surface a
    typed error the mount path can recover from, never a raw
    KeyError/zlib.error crash."""
    if magic == _MAGIC:
        return body
    from ..common.compressor import Compressor

    try:
        n = body[0]
        name = body[1:1 + n].decode()
    except (IndexError, UnicodeDecodeError) as e:
        raise MalformedInput(f"os.wal_checkpoint: bad compressor "
                             f"tag: {e}")
    try:
        codec = Compressor(name)
    except KeyError as e:
        raise MalformedInput(f"os.wal_checkpoint: {e.args[0]}")
    try:
        return codec.decompress(body[1 + n:])
    except Exception as e:
        raise MalformedInput(f"os.wal_checkpoint: body fails "
                             f"{name} decompression: {e!r}")


def _crc32c(data: bytes) -> int:
    from ..ec.stripe import crc32c as _c

    return int(_c(data))


# -- pure record/checkpoint codecs (the corpus types) ----

def encode_record(seq: int, ops: List[Tuple]) -> bytes:
    """One WAL record: header (magic, seq, len, crc32c) + bincode txn
    payload.  Records are never compressed — their latency is the
    write ack path."""
    enc = Encoder()
    encode_txn(ops, enc)
    payload = enc.bytes()
    return _HDR.pack(_MAGIC, seq, len(payload),
                     _crc32c(payload)) + payload


def decode_record(buf: bytes, pos: int = 0) -> Tuple[int, bytes, int]:
    """Parse one record at ``pos``; returns (seq, payload, end).
    Every torn/forged shape — short header, bad magic, truncated
    payload, crc mismatch — raises MalformedInput, which replay
    interprets as the un-acked tail."""
    if pos + _HDR.size > len(buf):
        raise MalformedInput("os.wal_record: truncated header")
    magic, seq, ln, crc = _HDR.unpack_from(buf, pos)
    if magic != _MAGIC:
        raise MalformedInput(f"os.wal_record: bad magic {magic:#x}")
    end = pos + _HDR.size + ln
    if end > len(buf):
        raise MalformedInput("os.wal_record: truncated payload")
    payload = buf[pos + _HDR.size:end]
    if _crc32c(payload) != crc:
        raise MalformedInput("os.wal_record: crc mismatch")
    return seq, payload, end


def encode_checkpoint(seq: int,
                      colls: Dict[str, Dict[str, _Object]],
                      comp=None) -> bytes:
    """The full checkpoint file image: header + (optionally
    compressed) bincode-enveloped store snapshot."""
    enc = Encoder()
    enc.start(CHECKPOINT_V, 1)
    enc.u64(seq)
    enc.u32(len(colls))
    for cid in sorted(colls):
        enc.str_(cid)
        objs = colls[cid]
        enc.u32(len(objs))
        for oid in sorted(objs):
            o = objs[oid]
            enc.str_(oid)
            enc.blob(o.data)  # staged by reference; materialised by
            # the enc.bytes() join below, under the store lock
            enc.str_blob_map(o.xattr)
            enc.str_blob_map(o.omap)
    enc.finish()
    magic, body = _pack_body(enc.bytes(), comp)
    return _HDR.pack(magic, seq, len(body), _crc32c(body)) + body


def decode_checkpoint(raw: bytes
                      ) -> Tuple[int, Dict[str, Dict[str, _Object]]]:
    """Returns (seq, collections).  All corruption classes — short
    file, bad magic, length/crc mismatch, unknown compressor,
    truncated compressed body, envelope damage — raise MalformedInput
    so mount() can fall back to WAL replay instead of crashing."""
    if len(raw) < _HDR.size:
        raise MalformedInput("os.wal_checkpoint: truncated header")
    magic, seq, ln, crc = _HDR.unpack_from(raw)
    body = raw[_HDR.size:_HDR.size + ln]
    if magic not in (_MAGIC, _MAGIC_Z) or len(body) != ln \
            or _crc32c(body) != crc:
        raise MalformedInput(
            "os.wal_checkpoint: bad magic/length/crc")
    dec = Decoder(_unpack_body(magic, body),
                  struct_name="os.wal_checkpoint")
    dec.start(CHECKPOINT_V)
    got_seq = dec.u64()
    if got_seq != seq:
        raise MalformedInput(
            f"os.wal_checkpoint: header seq {seq} != body seq "
            f"{got_seq}")
    colls: Dict[str, Dict[str, _Object]] = {}
    for _ in range(dec.u32()):
        cid = dec.str_()
        objs: Dict[str, _Object] = {}
        for _ in range(dec.u32()):
            oid = dec.str_()
            o = _Object()
            o.data = bytearray(dec.blob())
            o.xattr = dec.str_blob_map()
            o.omap = dec.str_blob_map()
            objs[oid] = o
        colls[cid] = objs
    dec.finish()
    return seq, colls


class _TxnWaiter:
    """One queued transaction's completion: set (durable) or errored
    by whichever group-commit leader's fsync — or checkpoint — covered
    it."""

    __slots__ = ("done", "error")

    def __init__(self):
        self.done = threading.Event()
        self.error: Optional[BaseException] = None

    def finish(self, error: Optional[BaseException] = None) -> None:
        if error is not None and self.error is None:
            self.error = error
        self.done.set()


@guarded_by("os::wal", "_pending", "_seq")
class WALStore(ObjectStore):
    def __init__(self, path: str, checkpoint_every_bytes: int = 1 << 24,
                 sync: bool = True, compression: str = "zlib",
                 group_commit_max_delay_us: int = 0, copy_coll=None):
        from ..common.compressor import Compressor

        self.path = path
        # byte-copy ledger target (see MemStore.__init__): the
        # mounting daemon's collection, or the process-global one
        self._copy_coll = copy_coll
        self._copy_pc = copytrack.ledger(copy_coll)
        self.log = getLogger("wal")
        # set when mount() found a checkpoint it could not decode and
        # fell back to WAL-only recovery — surfaced, not swallowed
        self.last_mount_error: Optional[str] = None
        # checkpoints compress through the registry (WAL records stay
        # raw: their latency is the write ack path); mount reads both
        # formats, so the option can change between runs
        self._comp = Compressor(compression)
        self._mem = MemStore(copy_coll=copy_coll)
        self._wal_path = os.path.join(path, "wal.log")
        self._ckpt_path = os.path.join(path, "checkpoint")
        self._wal_f = None
        self._seq = 0  # newest journaled+visible txn seq
        self._ckpt_seq = 0
        self._wal_bytes = 0
        self._ckpt_every = checkpoint_every_bytes
        self._sync = sync
        self._lock = make_rlock("os::wal")
        # -- group commit (the kv_sync_thread role, leader-elected) --
        # appended-but-not-yet-fsynced txns awaiting the shared fsync;
        # guarded by the store lock.  The first waiter to take the
        # sync mutex plays kv_sync_thread for everyone queued (a
        # dedicated thread would leak into every abandoned test
        # store); with one writer the leader is the writer itself —
        # the synchronous depth-1 fallback, identical to the old
        # fsync-per-txn path.
        self._pending: List[Tuple[int, _TxnWaiter]] = []
        self._sync_mutex = make_lock("os::wal_sync")
        self._wal_gen = 0  # bumped whenever _wal_f is replaced, so a
        # leader fsyncing a stale fd can tell a swap from a failure
        self._group_delay = max(0, group_commit_max_delay_us) / 1e6
        # test seam: runs between the group's last append and the
        # shared fsync (crash-consistency fault injection)
        self._fault_before_sync: Optional[Callable[[List[int]],
                                                   None]] = None

    # -- lifecycle ----------------------------------------------------
    def mkfs(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        self._write_checkpoint(seq=0)
        with open(self._wal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())

    def mount(self) -> None:
        with self._lock:
            self._load_checkpoint()
            valid_end = self._replay_wal()
            # a torn tail must be CUT, not appended past: records
            # written after garbage bytes would be unreachable to the
            # next replay, silently dropping acked transactions
            try:
                size = os.path.getsize(self._wal_path)
            except FileNotFoundError:
                size = 0
                open(self._wal_path, "wb").close()
            if valid_end < size:
                with open(self._wal_path, "r+b") as f:
                    f.truncate(valid_end)
                    f.flush()
                    os.fsync(f.fileno())  # conc-ok: mount-time only; nothing else can hold the store yet
            self._wal_f = open(self._wal_path, "ab")
            self._wal_bytes = self._wal_f.tell()

    def umount(self) -> None:
        with self._lock:
            if self._wal_f is not None:
                self.checkpoint()
                self._wal_f.close()
                self._wal_f = None

    # -- the write path (group commit) --------------------------------
    def queue_transaction(self, txn: Transaction) -> None:
        """Append under the store lock, share the fsync.

        Concurrent transactions append to the log back to back (the
        store lock is the journal order) but the fsync — the ack
        point — is COALESCED: the first waiter to take the sync mutex
        fsyncs once for every record appended so far and completes
        all their waiters (BlueStore's kv_sync_thread aggregation,
        leader-elected).  N concurrent shard writes cost ~1-2 fsyncs
        instead of N.  Returning still means durable: this call blocks
        until a shared fsync (or a checkpoint) covered the record."""
        waiter = None
        with self._lock:
            assert self._wal_f is not None, "not mounted"
            # 1. encode (an unencodable txn never journals) and
            #    validate + stage in memory (atomic: all ops or none)
            seq = self._seq + 1
            rec = encode_record(seq, txn.ops)
            commit = self._mem.prepare_transaction(txn)
            # 2. journal the record (buffered write + flush; the
            #    shared fsync below is the ack point).  Journal BEFORE
            #    the visible swap: if the append fails (ENOSPC, EIO)
            #    the store state still equals the journal.
            try:
                if faults.fires("os.torn_append"):
                    # the torn-write crash image: half the record
                    # reaches the log, then the append "dies" — the
                    # rollback below must cut the torn bytes so they
                    # can never replay
                    self._wal_f.write(rec[:max(1, len(rec) // 2)])
                    self._wal_f.flush()
                    raise OSError(errno.EIO, "injected torn append")
                self._wal_f.write(rec)
                self._wal_f.flush()
            except Exception:
                # the append may have partially landed (buffered
                # bytes, EIO).  Roll the log back to the last valid
                # record boundary — the end of the last GOOD append,
                # fsynced or not: earlier group members' records must
                # survive the cut — so the failed txn can never replay
                # and later records are never stranded behind torn
                # bytes; if even that fails, poison the store.
                self._rollback_wal()
                raise
            # 3. the journaled record exists: swap state in (cannot
            #    fail).  Visible-before-durable, like the reference's
            #    on_applied vs on_commit split — the caller's ack
            #    (this call returning) still waits for the fsync.
            self._seq = seq
            commit()
            self._wal_bytes += len(rec)
            _pc.inc("txns")
            # copy ledger: the journal record materialises every op
            # payload once (encode_record above), and the MemStore
            # commit splices write payloads into backing bytearrays
            # once more (this path bypasses MemStore.queue_transaction
            # and its booking — prepare_transaction is called
            # directly, so this is the only site that counts it)
            copytrack.book_pc(self._copy_pc, "store_txn", len(rec),
                              copies=2)
            if self._sync:
                waiter = _TxnWaiter()
                self._pending.append((seq, waiter))
            if self._wal_bytes >= self._ckpt_every:
                self.checkpoint()  # completes every pending waiter
        if waiter is None:
            return
        # leader-follower: whoever holds the sync mutex fsyncs for
        # everyone queued; everyone else just waits for their waiter.
        while not waiter.done.is_set():
            if self._sync_mutex.acquire(timeout=0.05):
                try:
                    if not waiter.done.is_set():
                        self._drain_group()
                finally:
                    self._sync_mutex.release()
        if waiter.error is not None:
            raise waiter.error

    def _drain_group(self) -> None:
        """The shared fsync, run under the sync mutex: complete every
        transaction appended so far with ONE fsync."""
        if self._group_delay > 0:
            # widen the group: let concurrent writers land their
            # appends before the shared fsync (bounded by the knob)
            time.sleep(self._group_delay)  # the sync mutex is the group-commit leader role, not a data lock; waiting here IS the coalescing window
        with self._lock:
            batch, self._pending = self._pending, []
            f, gen = self._wal_f, self._wal_gen
        if not batch:
            return
        if self._fault_before_sync is not None:
            self._fault_before_sync([seq for seq, _w in batch])
        t0 = time.monotonic()
        err: Optional[BaseException] = None
        for _attempt in range(2):
            try:
                if f is None:
                    raise OSError("store poisoned (journal failure)")
                if faults.fires("os.fsync_eio"):
                    # a bad sector under the journal: the store must
                    # poison itself — memory shows the txns but disk
                    # cannot prove them (the reference asserts out)
                    raise OSError(errno.EIO, "injected fsync error")
                os.fsync(f.fileno())  # the shared group fsync IS the ack point; the sync mutex serializes leaders, appends proceed under the store lock meanwhile
                err = None
                break
            except Exception as e:
                err = e
                with self._lock:
                    if self._wal_gen == gen:
                        # genuine fsync failure on the live journal:
                        # memory already shows these txns (visible-
                        # before-durable) but the disk cannot prove
                        # them — the acked-write contract is gone.
                        # Poison the store and fail every waiter (the
                        # reference asserts out on journal fsync
                        # failure for the same reason).
                        self._wal_f = None
                        self._wal_gen += 1
                        break
                    # the fd was swapped under us (another writer's
                    # append-failure rollback reopened the log); this
                    # group's records survived the cut — retry the
                    # fsync on the new fd
                    f, gen = self._wal_f, self._wal_gen
        if err is not None:
            for _seq, w in batch:
                w.finish(err if isinstance(err, OSError)
                         else OSError(repr(err)))
            return
        _pc.inc("group_commits")
        _pc.tinc("group_commit_time", time.monotonic() - t0)
        _pc.hist_add("wal_group_size", len(batch))
        for _seq, w in batch:
            w.finish()

    def _rollback_wal(self) -> None:
        """Truncate the log back to ``_wal_bytes`` (the end of the
        last good append — group members' not-yet-fsynced records must
        survive the cut) after a failed append — the runtime twin of
        mount()'s torn-tail cut."""
        try:
            try:
                self._wal_f.close()
            except Exception:
                pass
            with open(self._wal_path, "r+b") as f:
                f.truncate(self._wal_bytes)
                f.flush()
                os.fsync(f.fileno())
            self._wal_f = open(self._wal_path, "ab")
        except Exception:
            self._wal_f = None  # poisoned: every later op asserts
        finally:
            self._wal_gen += 1

    # -- checkpointing ------------------------------------------------
    def checkpoint(self) -> None:
        """Fold the WAL into a durable snapshot and truncate it.

        Completes every pending group-commit waiter too: the snapshot
        holds their (already visible) state, so the rename IS their
        durability — no separate fsync needed."""
        with self._lock:
            batch, self._pending = self._pending, []
            self._write_checkpoint(self._seq)
            self._ckpt_seq = self._seq
            # crash after the rename but before this truncate replays
            # records with seq <= ckpt seq; the seq check skips them.
            # Truncate IN PLACE (append-mode writes land at EOF
            # regardless): the fd must stay valid — a group-commit
            # leader may be fsyncing it right now, which must not see
            # the journal yanked out from under it
            if self._wal_f is not None:
                self._wal_f.flush()
                os.ftruncate(self._wal_f.fileno(), 0)
                if self._sync:
                    os.fsync(self._wal_f.fileno())  # conc-ok: checkpoint must be atomic vs writers; the lock is the barrier
            self._wal_bytes = 0
        for _seq, w in batch:
            w.finish()

    def _write_checkpoint(self, seq: int) -> None:
        os.makedirs(self.path, exist_ok=True)
        blob = encode_checkpoint(seq, self._mem._coll, self._comp)
        tmp = self._ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._ckpt_path)  # atomic on POSIX
        if self._sync:
            dirfd = os.open(self.path, os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)

    def _load_checkpoint(self) -> None:
        self._mem = MemStore(copy_coll=self._copy_coll)
        self._seq = self._ckpt_seq = 0  # race-ok: mount-time, before any writer thread exists
        self.last_mount_error = None
        try:
            raw = open(self._ckpt_path, "rb").read()
        except FileNotFoundError:
            return
        try:
            seq, colls = decode_checkpoint(raw)
        except MalformedInput as e:
            # an undecodable checkpoint (unknown compressor tag,
            # truncated compressed body, bit rot) must not brick the
            # store: surface the error and recover from the WAL alone
            # (ckpt_seq stays 0, so every journaled record replays).
            # Anything folded into the bad checkpoint and already
            # truncated out of the WAL is gone either way — mounting
            # what the journal proves beats refusing to mount.
            self.last_mount_error = (
                f"checkpoint at {self._ckpt_path} undecodable "
                f"({e}); recovering from WAL only")
            self.log.derr(f"wal: {self.last_mount_error}")
            return
        self._mem._coll = colls
        self._seq = self._ckpt_seq = seq  # race-ok: mount-time, before any writer thread exists

    def _replay_wal(self) -> int:
        """Apply WAL records past the checkpoint; stop at the first
        torn/corrupt record (the un-acked tail).  Returns the byte
        offset of the end of the last valid record, so mount can
        truncate the torn tail before appending."""
        try:
            raw = open(self._wal_path, "rb").read()
        except FileNotFoundError:
            return 0
        pos = 0
        while pos < len(raw):
            try:
                seq, payload, end = decode_record(raw, pos)
            except MalformedInput:
                break  # torn tail
            if seq <= self._ckpt_seq:
                pos = end
                continue  # folded into the checkpoint already
            try:
                ops = decode_txn(Decoder(payload))
            except DecodeError:
                break
            txn = Transaction()
            txn.ops = ops
            try:
                self._mem.queue_transaction(txn)
            except Exception as e:
                # a record whose base state is gone (checkpoint lost
                # to bit rot, so this txn's preconditions vanished):
                # stop replay at the last applicable prefix and SAY
                # so — the prefix contract holds, the loss is
                # surfaced, and the store still mounts
                self.last_mount_error = (
                    (self.last_mount_error or "") +
                    f"; WAL record seq {seq} no longer applies "
                    f"({e!r}) — replay stopped there").lstrip("; ")
                self.log.derr(f"wal: {self.last_mount_error}")
                break
            pos = end
            self._seq = seq  # race-ok: mount-time replay, single-threaded before any writer exists
        return pos

    # -- reads delegate to the in-memory twin -------------------------
    def read(self, cid, oid, offset=0, length=-1) -> bytes:
        return self._mem.read(cid, oid, offset, length)

    def stat(self, cid, oid) -> Optional[Dict]:
        return self._mem.stat(cid, oid)

    def getattr(self, cid, oid, key) -> Optional[bytes]:
        return self._mem.getattr(cid, oid, key)

    def omap_get(self, cid, oid) -> Dict[str, bytes]:
        return self._mem.omap_get(cid, oid)

    def list_collections(self) -> List[str]:
        return self._mem.list_collections()

    def list_objects(self, cid) -> List[str]:
        return self._mem.list_objects(cid)

    def collection_exists(self, cid) -> bool:
        return self._mem.collection_exists(cid)
