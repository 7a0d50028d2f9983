"""Messenger — threaded TCP transport with typed dispatch and
session-layer reliability.

The port's copy of ``ceph_tpu/msg/messenger.py``: the same frames byte
for byte, the same session layer, on the port's bufpool, tracer,
failpoints, watchdog and asyncheck.  A ``torch.Tensor`` (anything with
``__dlpack__``) inside a message raises ``TypeError``: it is never
copied off its device behind the caller's back.

The Messenger/Dispatcher seam (src/msg/Messenger.h, Dispatcher.h,
AsyncMessenger.cc) plus the ProtocolV2 session layer
(src/msg/async/ProtocolV2.cc).

Framing (the reference message's header/front/DATA segmentation,
src/msg/Message.h: payload vs data bufferlists; ProtocolV2 rev1
frames): one length word, a version byte, then a JSON control segment
and N RAW binary segments.  ``bytes`` values anywhere in a message
dict are lifted out of the control segment and travel as raw
attachments — zero hex/base64 inflation, no JSON escaping, exactly
like MOSDOp carrying its data payload outside the front segment.  The
control segment optionally zlib-compresses (wire compression role);
data segments never do (payload bytes are entropy-dense, and the
reference compresses per-policy, not always).

On top of it, LOSSLESS peers (daemon↔daemon — the reference's
CEPH_MSGR_POLICY_LOSSLESS) get sequence-numbered frames with
ack/replay semantics:

- every sequenced frame carries (_sess, _s); the receiver keeps
  in_seq per (peer, session) and a bounded reply cache, so a frame
  that arrives twice (retransmission after a dropped connection) is
  deduplicated and its original reply is resent — exactly-once
  handler execution per session, the reconnect/replay contract of
  ProtocolV2.cc (out_seq/in_seq + requeue_sent).
- the sender buffers unacked frames; a reconnect handshake
  (``__hello__``) learns the peer's in_seq and retransmits only the
  tail; explicit ``__ack__`` frames trim the buffer in steady state.
  A reader-thread death with unacked frames triggers a background
  resync so a dropped TCP connection mid-op-stream heals without
  waiting for the next application send.
- the HMAC (msg/auth.py) signs the body INCLUDING (_sess, _s), so a
  captured frame replayed verbatim is rejected by the in_seq check —
  the cephx nonce-binding role.
- LOSSY peers (clients) keep the old fire-and-forget behavior
  (CEPH_MSGR_POLICY_LOSSY: the application's map-retry loop owns
  recovery), but every receiver still deduplicates sequenced traffic.

Per-type byte throttles (``throttles={type: Throttle}``) bound memory
taken by in-flight messages of a type before dispatch — the
osd_client_message_size_cap role (ceph_osd.cc:582-588).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import socket
import struct
import threading
import time
import uuid
import zlib
from typing import Callable, Dict, Optional, Tuple

from ..analysis import asyncheck
from ..analysis import faults
from ..analysis import watchdog
from ..analysis.asyncheck import nonblocking
from ..analysis.lockdep import make_lock, make_rlock
from ..analysis.racecheck import guarded_by, shared
from ..common import bufpool
from ..common import copytrack
from ..common.backoff import Backoff
from ..common.encoding import MalformedInput
from ..common.log import getLogger
from ..common.perf_counters import PerfCounters
from ..common.tracing import Tracer

Addr = Tuple[str, int]
Handler = Callable[[Dict], Optional[Dict]]

# per-socket writers: sendall() on a large frame loops, so two threads
# writing the same cached connection would interleave bytes and corrupt
# the framing.  Beyond mutual exclusion, writers COALESCE: frames for
# one socket queue behind the current sender, and whichever thread
# holds the writer lock flushes everything queued in ONE send — a
# primary fanning a write out no longer pays a syscall + lock
# round-trip per frame sharing a connection.
#
# Entries are reaped on conn death, hard close, AND send failure (the
# old per-socket lock table leaked one entry per reconnect cycle: a
# send racing reader death re-created the entry after the reader's
# exit had reaped it, and nothing ever removed it again).


class _SendOp:
    __slots__ = ("buf", "done", "error")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.done = threading.Event()
        self.error: Optional[OSError] = None


class _SockWriter:
    __slots__ = ("lock", "q")

    def __init__(self):
        self.lock = make_lock("msgr::send")
        self.q: "collections.deque[_SendOp]" = collections.deque()


# mutation-checked under racecheck: every writer-table insert/reap
# must hold the guard; the lock-free reads in _send/dump_messenger
# are the deliberate GIL-atomic idiom shared() leaves legal
_sock_writers: Dict[int, _SockWriter] = shared(
    {}, "msgr::send_guard", "msgr.sock_writers")
_sock_writers_guard = make_lock("msgr::send_guard")

# A send slower than this is socket backpressure (or an armed wire
# fault), not syscall cost: only those book send_stall_time, so an
# idle cluster's meter reads exactly zero and any nonzero value means
# the kernel buffer pushed back.
_STALL_MIN_S = 1e-3

# stateless reusable null context for the data-lane handler path (a
# data handler may legitimately block on fan-out; only the control
# lane carries the non-blocking contract)
_NULL_CTX = contextlib.nullcontext()


class _ConnStats:
    """Per-connection saturation books (the ms_async per-connection
    logger role): byte/frame volume, cumulative send-stall time, and
    dispatch wait/latency sums split by lane — the raw material of
    ``dump_messenger``.  Fields are bumped lock-free from reader,
    sender and pool-worker threads; a torn ``+=`` under the GIL can
    lose an individual sample, which telemetry tolerates (the same
    trade the reference's perf counters make on relaxed atomics)."""

    __slots__ = ("peer", "bytes_in", "bytes_out", "frames_in",
                 "frames_out", "sends", "send_stall_s", "send_stalls",
                 "q_depth_peak", "wait_ctl_s", "wait_ctl_n",
                 "wait_data_s", "wait_data_n", "lat_ctl_s",
                 "lat_ctl_n", "lat_data_s", "lat_data_n")

    def __init__(self, peer: str):
        self.peer = peer
        self.bytes_in = 0
        self.bytes_out = 0
        self.frames_in = 0
        self.frames_out = 0
        self.sends = 0
        self.send_stall_s = 0.0
        self.send_stalls = 0
        self.q_depth_peak = 0
        self.wait_ctl_s = 0.0
        self.wait_ctl_n = 0
        self.wait_data_s = 0.0
        self.wait_data_n = 0
        self.lat_ctl_s = 0.0
        self.lat_ctl_n = 0
        self.lat_data_s = 0.0
        self.lat_data_n = 0

    def dump(self) -> Dict:
        return {
            "peer": self.peer,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "sends": self.sends,
            "send_stall_s": round(self.send_stall_s, 6),
            "send_stalls": self.send_stalls,
            "queue_depth_peak": self.q_depth_peak,
            "dispatch_wait_ctl": {
                "n": self.wait_ctl_n,
                "avg_ms": round(1e3 * self.wait_ctl_s
                                / self.wait_ctl_n, 3)
                if self.wait_ctl_n else 0.0},
            "dispatch_wait_data": {
                "n": self.wait_data_n,
                "avg_ms": round(1e3 * self.wait_data_s
                                / self.wait_data_n, 3)
                if self.wait_data_n else 0.0},
            "dispatch_lat_ctl": {
                "n": self.lat_ctl_n,
                "avg_ms": round(1e3 * self.lat_ctl_s
                                / self.lat_ctl_n, 3)
                if self.lat_ctl_n else 0.0},
            "dispatch_lat_data": {
                "n": self.lat_data_n,
                "avg_ms": round(1e3 * self.lat_data_s
                                / self.lat_data_n, 3)
                if self.lat_data_n else 0.0},
        }


def _writer_for(sock) -> _SockWriter:
    with _sock_writers_guard:
        w = _sock_writers.get(id(sock))
        if w is None:
            w = _sock_writers[id(sock)] = _SockWriter()
        return w


def _reap_writer(sock) -> None:
    with _sock_writers_guard:
        _sock_writers.pop(id(sock), None)

_UNACKED_CAP = 512      # frames buffered per lossless peer session
_REPLY_CACHE_CAP = 128  # replies cached per remote session

# call-correlation tids: random per-process prefix + counter.  As
# unique as a uuid4 per call for correlation purposes, at ~1/6 the
# cost — tids are minted 3+ times per client op on the data path.
_tid_prefix = uuid.uuid4().hex[:12]
_tid_counter = itertools.count(1)


def _next_tid() -> str:
    return f"{_tid_prefix}{next(_tid_counter):x}"


# control segments beyond this compress on the wire (map payloads and
# other large JSON; raw data segments are never compressed)
_COMPRESS_OVER = 16 << 10
_FRAME_V = 2        # frame format version byte
_FL_ZLIB = 0x01     # control segment is zlib-compressed

_BLOB_KEY = "__frame_blob__"
_ESC_KEY = "__frame_esc__"

# blob-table sanity ceiling: nothing legitimate ships this many data
# segments in one frame, and a forged count must not allocate first
_MAX_BLOBS = 1 << 16

# decompression-bomb ceiling: a compressed control segment may expand
# to at most this much.  The largest legitimate control segment is a
# full-map JSON payload (a few MB at 10k OSDs — big maps travel as
# binary map_bin data segments anyway); a 1 KiB frame claiming 100 MiB
# of zeros is an attack on the receiver's memory, and the reference
# bounds inbound message memory the same way
# (osd_client_message_size_cap).  Module-level so tests can lower it.
MAX_DECOMPRESSED = 32 << 20


def _lift_blobs(obj, blobs: list):
    """Replace every bytes-like value with a data-segment reference —
    the front/data split of the reference's Message bufferlists.  A
    LITERAL single-key dict that collides with either wire sentinel is
    escaped so _restore_blobs hands it back verbatim instead of
    resolving it into an unrelated data segment.

    Blobs are kept as the caller's buffer-protocol object (bytes,
    bytearray, memoryview) — NOT copied: the frame is materialised in
    exactly one gathered join at send time (`_send_frame`), and the
    caller's buffer is only read while it blocks in the send.

    A tensor (or any array with ``__dlpack__``) raises ``TypeError``,
    as it does in ``ceph_tpu``'s JSON encoder: bring it to the host as
    bytes first, where the copy can be seen and booked."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        blobs.append(obj)
        return {_BLOB_KEY: len(blobs) - 1}
    if hasattr(obj, "__dlpack__"):
        raise TypeError(f"a {type(obj).__name__} cannot travel in a "
                        f"message: send its bytes")
    if isinstance(obj, dict):
        if len(obj) == 1 and next(iter(obj)) in (_BLOB_KEY, _ESC_KEY):
            return {_ESC_KEY: {k: _lift_blobs(v, blobs)
                               for k, v in obj.items()}}
        return {k: _lift_blobs(v, blobs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_lift_blobs(v, blobs) for v in obj]
    return obj


def _restore_blobs(obj, blobs: list):
    if isinstance(obj, dict):
        if len(obj) == 1 and _BLOB_KEY in obj:
            idx = obj[_BLOB_KEY]
            if not isinstance(idx, int) or not 0 <= idx < len(blobs):
                raise MalformedInput(
                    f"blob index {idx!r} out of range "
                    f"(frame has {len(blobs)})")
            return blobs[idx]
        if len(obj) == 1 and _ESC_KEY in obj:
            inner = obj[_ESC_KEY]
            if not isinstance(inner, dict):
                raise MalformedInput("malformed sentinel escape")
            return {k: _restore_blobs(v, blobs)
                    for k, v in inner.items()}
        return {k: _restore_blobs(v, blobs) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_restore_blobs(v, blobs) for v in obj]
    return obj


def _materialize_views(obj, pc=None, site: str = "recv"):
    """Deep-copy every memoryview leaf to bytes — the DELIBERATE copy
    for data that outlives its pooled recv segment (a reply payload
    handed to a waiting caller, a cached reply that a retransmission
    may resend seconds later).  Booked per leaf at the given ledger
    site; anything without views passes through untouched."""
    if isinstance(obj, memoryview):
        b = bytes(obj)  # copy-ok: stabilizing a view past its segment
        if pc is not None:
            copytrack.book_pc(pc, site, len(b), copies=1)
        return b
    if isinstance(obj, dict):
        return {k: _materialize_views(v, pc, site)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_materialize_views(v, pc, site) for v in obj]
    return obj


def encode_frame_parts(msg: Dict, keyring=None):
    """The pure frame codec, encode half, as a GATHER LIST: header +
    JSON control segment + blob table, with every data segment still
    the caller's buffer (no per-blob copy).  Returns (parts, nbytes);
    the transport joins the list exactly once at send time — the one
    deliberate, booked send-side materialisation."""
    blobs: list = []
    jmsg = _lift_blobs(msg, blobs)
    if keyring is not None:
        jmsg.pop("mac", None)
        jmsg["mac"] = keyring.sign(jmsg, blobs)
    body = json.dumps(jmsg).encode()  # wire-ok: the frame codec seam
    flags = 0
    if len(body) > _COMPRESS_OVER:
        body = zlib.compress(body, 1)
        flags |= _FL_ZLIB
    parts = [struct.pack("<BBI", _FRAME_V, flags, len(body)), body,
             struct.pack("<I", len(blobs))]
    nbytes = 10 + len(body)
    for b in blobs:
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
        nbytes += 4 + len(b)
    return parts, nbytes


def encode_frame(msg: Dict, keyring=None) -> bytes:
    """The pure frame codec, encode half (the wirecheck-registered
    seam): header + JSON control segment + blob table.  The outer
    length word is the transport's, added at send time."""
    parts, _n = encode_frame_parts(msg, keyring)
    return b"".join(parts)


def decode_frame(payload) -> Tuple[Dict, list]:
    """The pure frame codec, decode half.  Returns (msg, blobs);
    ``msg`` still holds data-segment references (the dispatcher
    restores them after MAC verification).  ``payload`` may be bytes
    or a memoryview over a pooled recv segment — data segments come
    back as ZERO-COPY slices of it (views are only valid while the
    segment is held; anything outliving the frame copies deliberately
    via ``_materialize_views``).  Every length field is bounds-checked
    against the frame, every parse failure raises MalformedInput: a
    truncated, forged, or compression-bomb frame must be a clean
    protocol error, never an uncaught struct.error (or an unbounded
    allocation) that kills the reader thread with its cleanup
    skipped."""
    if len(payload) < 6:
        raise MalformedInput(
            f"frame too short ({len(payload)} bytes)")
    ver, flags, jlen = struct.unpack_from("<BBI", payload, 0)
    if ver != _FRAME_V:
        # the frame-format compat floor: a peer speaking a newer
        # framing must be refused, not misparsed
        raise MalformedInput(f"unknown frame version {ver}, "
                             f"have v{_FRAME_V}")
    pos = 6
    if pos + jlen + 4 > len(payload):
        raise MalformedInput("truncated control segment")
    body = payload[pos:pos + jlen]
    pos += jlen
    if flags & _FL_ZLIB:
        d = zlib.decompressobj()
        try:
            body = d.decompress(body, MAX_DECOMPRESSED)
        except zlib.error as e:
            raise MalformedInput(f"bad compressed control: {e}")
        if d.unconsumed_tail or not d.eof:
            raise MalformedInput(
                f"control segment decompresses past the "
                f"{MAX_DECOMPRESSED}-byte cap")
    (nblobs,) = struct.unpack_from("<I", payload, pos)
    pos += 4
    if nblobs > _MAX_BLOBS or nblobs * 4 > len(payload) - pos:
        raise MalformedInput(f"blob table oversized ({nblobs} entries "
                             f"in {len(payload) - pos} bytes)")
    blobs = []
    for _ in range(nblobs):
        if pos + 4 > len(payload):
            raise MalformedInput("truncated blob table")
        (blen,) = struct.unpack_from("<I", payload, pos)
        pos += 4
        if pos + blen > len(payload):
            raise MalformedInput("truncated blob")
        blobs.append(payload[pos:pos + blen])
        pos += blen
    if isinstance(body, memoryview):
        # copy-ok: control segment only — json needs a bytes object;
        # the data segments above stay views of the pooled payload
        body = bytes(body)
    try:
        msg = json.loads(body.decode())  # wire-ok: the frame codec seam
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise MalformedInput(f"undecodable control segment: {e}")
    if not isinstance(msg, dict):
        raise MalformedInput(
            f"control segment is {type(msg).__name__}, not an object")
    return msg, blobs


_HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


def _sendmsg_all(sock: socket.socket, parts: list) -> None:
    """Scatter-gather send of the whole parts list (the writev role)
    with partial-send continuation — the data segments go from the
    caller's buffers straight to the kernel, never joined in
    userspace."""
    views = [memoryview(p) for p in parts]
    while views:
        n = sock.sendmsg(views)
        while views and n >= len(views[0]):
            n -= len(views[0])
            views.pop(0)
        if views and n:
            views[0] = views[0][n:]


def _send_frame(sock: socket.socket, msg: Dict, keyring=None,
                mutate=None) -> Tuple[int, int]:
    """Queue the frame on the socket's writer and flush — coalescing
    with whatever else is queued — as the writer-lock holder.  Returns
    ``(wire_size, joined)``: the wire size (header + payload) for the
    byte counters, and how many bytes were actually materialised in a
    userspace join (0 on the gathered fast path — the caller books
    that at the "send" ledger site).  Raises the send failure on the
    CALLER's thread even when another thread's flush carried (and
    failed) this frame.

    ``mutate`` (fault injection only) post-processes the framed bytes
    — flipping or truncating them — INSIDE the writer path, so the
    damaged frame still serializes correctly against coalesced
    writers instead of interleaving mid-batch."""
    parts, plen = encode_frame_parts(msg, keyring)
    parts.insert(0, struct.pack(">I", plen))
    buf = None
    if mutate is not None:
        # fault injection needs the contiguous frame to damage it
        buf = mutate(b"".join(parts))
    elif not _HAS_SENDMSG:
        buf = b"".join(parts)
    w = _writer_for(sock)
    # uncontended fast path: writer idle, nothing queued — gathered
    # sendmsg straight from the caller's buffers, no join at all (the
    # common case; the coalescing machinery below only engages under
    # write contention)
    if not w.q and w.lock.acquire(blocking=False):
        fast = False
        try:
            if not w.q:
                fast = True
                if buf is not None:
                    sock.sendall(buf)
                else:
                    _sendmsg_all(sock, parts)
        except OSError:
            _reap_writer(sock)
            raise
        finally:
            w.lock.release()
        if fast:
            return plen + 4, len(buf) if buf is not None else 0
    # contended path: the frame joins once so the flush-holder can
    # batch it with its queue neighbours in one send
    if buf is None:
        buf = b"".join(parts)
    op = _SendOp(buf)
    w.q.append(op)  # deque.append is atomic; order = send order
    while not op.done.is_set():
        if not w.lock.acquire(timeout=0.05):
            continue
        try:
            while not op.done.is_set():
                batch = []
                try:
                    while True:
                        batch.append(w.q.popleft())
                except IndexError:
                    pass
                if not batch:
                    break
                err: Optional[OSError] = None
                try:
                    # ONE gathered send for the whole batch (the
                    # writev role): the dominant cost of small frames
                    # is per-send syscall + wakeup, not bytes
                    sock.sendall(b"".join(o.buf for o in batch))
                except OSError as e:
                    err = e
                for o in batch:
                    o.error = err
                    o.done.set()
        finally:
            w.lock.release()
    if op.error is not None:
        _reap_writer(sock)  # dead socket: never strand its entry
        raise op.error
    return plen + 4, len(buf)


def _flip_control_byte(buf: bytes) -> bytes:
    """Fault-injection mutation (msgr.corrupt_frame): XOR the first
    byte of the frame's control segment.  The control segment is the
    only region decode_frame ALWAYS integrity-checks (JSON parse /
    zlib inflate) — a flipped blob byte would pass silently and
    corrupt stored data, which models a disk fault, not a wire one —
    so this is guaranteed to surface as MalformedInput + session
    drop at the receiver."""
    # layout: [4B outer length][<BBI header = 6B][control body]...
    pos = 4 + 6
    if len(buf) <= pos:
        return buf
    out = bytearray(buf)
    out[pos] ^= 0xFF
    return out  # bytearray: sendall/join take it without another copy


def _truncate_frame(buf: bytes) -> bytes:
    """Fault-injection mutation (msgr.close_mid_frame): keep only the
    first half of the framed bytes — the receiver blocks on the
    remainder until the injected close EOFs it."""
    return buf[:max(4, len(buf) // 2)]


def _recv_into(sock: socket.socket, view: memoryview) -> bool:
    """Fill ``view`` from the socket; False on EOF.  recv_into a
    caller-owned view: a 64 KiB data frame arrives in a few segments
    and neither concatenates prefixes nor allocates per segment."""
    pos = 0
    n = len(view)
    while pos < n:
        got = sock.recv_into(view[pos:])
        if not got:
            return False
        pos += got
    return True


def _recv_exact(sock: socket.socket, n: int):
    """Preallocated recv_into (header words and tests)."""
    buf = bytearray(n)
    if not _recv_into(sock, memoryview(buf)):
        return None
    return buf


def _recv_frame(sock: socket.socket):
    """Returns (msg, blobs, nbytes, seg) or None on EOF; parse errors
    surface as MalformedInput from the codec and drop the session.

    The payload lands in a pooled segment (``seg``) via recv_into —
    the ONE recv-side materialisation of the frame — and ``blobs`` are
    zero-copy views into it.  Ownership of the segment (refcount 1)
    passes to the caller on success; EOF and parse errors release it
    here."""
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    seg = bufpool.acquire(length, tag="msgr.recv")
    try:
        if not _recv_into(sock, seg.writable()):
            seg.release()
            return None
        msg, blobs = decode_frame(seg.view())
    except BaseException:
        seg.release()
        raise
    return msg, blobs, length, seg


class _OutSession:
    """Sender-side lossless state for one peer address."""

    def __init__(self):
        self.lock = make_rlock("msgr::out_session")  # serializes seq
        # assignment, handshake, and transmission → frames hit the
        # wire in order
        # buf_lock guards ONLY the unacked buffer: acks arrive on
        # reader threads and must trim without waiting on a handshake
        # in progress (which itself waits on that reader — deadlock)
        self.buf_lock = make_lock("msgr::out_buf")
        self.out_seq = 0
        self.unacked: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()
        self.synced = False  # handshake done on the current conn
        # tids of calls in flight on this session (guarded by
        # buf_lock): when the background resync gives the peer up,
        # these waiters are failed IMMEDIATELY instead of burning
        # their full timeout against a dead daemon — the stall that
        # held a primary's PG lock for 10s per push during thrash
        self.waiters: set = set()

    def trim(self, upto: int) -> None:
        """Transport-level ack: drops fire-and-forget frames only.  A
        frame still waiting for its REPLY stays buffered even though
        the peer received it — the reply may have died with the old
        connection, and only the retransmission (deduped server-side,
        cached reply resent) can recover it.  call() completes those
        via complete()."""
        with self.buf_lock:
            for s in list(self.unacked):
                if s > upto:
                    break
                frame, needs_reply = self.unacked[s]
                if not needs_reply:
                    del self.unacked[s]

    def complete(self, seq: int) -> None:
        with self.buf_lock:
            self.unacked.pop(seq, None)

    def buffer(self, seq: int, frame: Dict,
               needs_reply: bool) -> None:
        with self.buf_lock:
            self.unacked[seq] = (frame, needs_reply)
            while len(self.unacked) > _UNACKED_CAP:
                self.unacked.popitem(last=False)  # degrade to lossy

    def pending(self):
        with self.buf_lock:
            return [f for f, _nr in self.unacked.values()]


class _InSession:
    """Receiver-side dedup state for one remote (name, session).

    ``fifo``/``draining`` implement the per-session serial dispatch
    lane: sequenced lossless frames from one peer session execute in
    arrival order (one lane worker at a time) while different sessions
    still share the dispatch pool concurrently — the reference's
    per-connection DispatchQueue ordering, which the quorum layer
    needs (mon_accept(v+1) must not overtake mon_commit(v))."""

    def __init__(self):
        self.in_seq = 0
        self.replies: "collections.OrderedDict[int, Dict]" = \
            collections.OrderedDict()
        self.fifo: "collections.deque" = collections.deque()
        self.draining = False

    def cache_reply(self, seq: int, frame: Dict) -> None:
        self.replies[seq] = frame
        while len(self.replies) > _REPLY_CACHE_CAP:
            self.replies.popitem(last=False)


@guarded_by("msgr::conn", "_conns", "_accepted", "_conn_waiters")
@guarded_by("msgr::pending", "_pending", "_waiters")
class Messenger:
    def __init__(self, name: str, host: str = "127.0.0.1",
                 port: int = 0, keyring=None, lossless: bool = False,
                 throttles: Optional[Dict[str, object]] = None,
                 tracer: Optional[Tracer] = None, perf=None):
        self.name = name
        self.log = getLogger("msgr")
        self.keyring = keyring  # cephx-style frame auth when set
        self.lossless = lossless
        # the tracing plane: daemons pass their context's tracer so
        # transport spans nest under service spans; a standalone
        # messenger (CLI, tests) gets its own
        self.tracer = tracer if tracer is not None else Tracer(
            f"msgr.{name}")
        # wire + dispatch metrics; registered into the daemon's
        # collection when one is passed (so `perf dump` serves them),
        # else standalone
        self.pc = perf.create(f"msgr.{name}") if perf is not None \
            else PerfCounters(f"msgr.{name}")
        for key in ("bytes_in", "bytes_out", "frames_in",
                    "frames_out"):
            self.pc.add_u64_counter(key)
        # receipt -> handler completion (queue wait + execution)
        self.pc.add_histogram("dispatch_lat")
        self.pc.add_time("dispatch_time")
        # the saturation plane: wall time _send spent stalled against
        # socket backpressure (only sends past _STALL_MIN_S book, so
        # an unloaded wire reads 0), the send-queue depth seen per
        # send, and the dispatch wait/latency histograms split by
        # lane — what dump_messenger reads
        self.pc.add_time("send_stall_time")
        self.pc.add_u64_counter("send_stalls")
        self.pc.add_histogram("send_queue_depth", min_value=1.0)
        self.pc.add_histogram("dispatch_wait_ctl")
        self.pc.add_histogram("dispatch_wait_data")
        self.pc.add_histogram("dispatch_lat_ctl")
        self.pc.add_histogram("dispatch_lat_data")
        # id(sock) -> _ConnStats, created on first traffic, reaped
        # with the reader (dict ops are GIL-atomic; no lock)
        self._conn_stats: Dict[int, _ConnStats] = {}
        # the byte-copy ledger (common/copytrack.py): recv/send copy
        # accounting books into the daemon's obs.copy counters when a
        # collection was passed, else the process-global ones
        self._copy_pc = copytrack.ledger(perf)
        self.session_id = uuid.uuid4().hex[:16]
        self.throttles = throttles or {}
        self._handlers: Dict[str, Handler] = {}
        self._ordered: set = set()  # types on the serial lane
        self._control: set = set()  # types on the control lane
        self._listener = socket.socket(socket.AF_INET,
                                       socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self._listener.settimeout(0.2)
        self.addr: Addr = self._listener.getsockname()
        self._running = False
        self._shut = False  # terminal: no reconnects past shutdown()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: Dict[Addr, socket.socket] = {}
        # accept-side sockets, so shutdown can close them and their
        # reader threads exit promptly instead of lingering blocked in
        # recv until the remote end dies (cross-test thread leakage)
        self._accepted: set = set()
        self._conn_lock = make_lock("msgr::conn")
        self._out: Dict[Addr, _OutSession] = {}
        self._in: Dict[Tuple[str, str], _InSession] = {}
        self._in_lock = make_lock("msgr::in")
        self._pending: Dict[str, Dict] = {}
        # tid -> per-call Event: a reply wakes exactly ITS caller.
        # (The old shared Condition notify_all'd every in-flight
        # caller per reply — O(window) wakeups per op, which made
        # throughput DROP as the aio window grew.)
        self._waiters: Dict[str, threading.Event] = {}
        # id(conn) -> tids of CONN-BOUND calls (lossy calls and the
        # __hello__ handshake — no session replay behind them): when
        # the conn's reader exits these fail immediately instead of
        # burning their full timeout against a dead peer.  A client
        # put() once waited 20s on an OSD killed mid-call, and a
        # resync handshake waited 5s holding the session lock.
        self._conn_waiters: Dict[int, set] = {}
        self._pending_lock = make_lock("msgr::pending")
        # lazy dispatch pools (DispatchQueue role); created on first
        # inbound op so pure clients never spawn them.  Two lanes: the
        # wide op pool, and a small CONTROL pool reserved for
        # latency-critical types (heartbeats, map/peering pushes) so a
        # burst of store ops occupying every op worker can never
        # head-of-line-block failure detection — the reference's
        # dedicated heartbeat messengers + mgr/mon priority queues.
        self._pool = None
        self._ctl_pool = None
        self._pool_lock = make_lock("msgr::pool")

    # -- dispatch ------------------------------------------------------
    def register(self, type_: str, handler: Handler,
                 ordered: bool = False,
                 control: bool = False) -> None:
        """Handler returns a reply dict (routed back by tid) or None.

        ``ordered=True`` puts the type on the per-session serial lane:
        sequenced frames of ordered types from one peer session run in
        arrival order relative to EACH OTHER (the reference's ordered
        DispatchQueue), which state machines like the quorum need —
        mon_accept(v+1) must not overtake mon_commit(v).  Unordered
        types keep full fast-dispatch parallelism (the reference's
        ms_fast_dispatch), so a store op blocking in the scheduler
        can never head-of-line-block a session's control traffic.

        ``control=True`` additionally dispatches the type on the
        dedicated control pool: a latency-critical frame (a heartbeat,
        a map push, a peering probe) must never queue behind a burst
        of shard writes that has every op worker blocked in the
        object store.  Composes with ``ordered`` (the serial lane
        drains on the control pool)."""
        self._handlers[type_] = handler
        if ordered:
            self._ordered.add(type_)
        if control:
            self._control.add(type_)

    def start(self) -> None:
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"msgr:{self.name}")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._listener.accept()
                # ms_tcp_nodelay (on by default in the reference):
                # Nagle + delayed ACK turns the request/ack/reply
                # triple into double-digit-ms stalls
                conn.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conn_lock:
                self._accepted.add(conn)
            threading.Thread(target=self._reader, args=(conn, None),
                             daemon=True,
                             name=f"msgr-rd:{self.name}").start()

    def _reader(self, conn: socket.socket, addr: Optional[Addr]) -> None:
        """``addr`` set = a client-initiated connection we own; its
        death with unacked frames triggers a background resync."""
        with conn:
            while self._running:
                try:
                    got = _recv_frame(conn)
                except (OSError, ValueError, struct.error,
                        zlib.error):
                    break  # closed or corrupt frame: drop the session
                if got is None:
                    break
                msg, blobs, nbytes, seg = got
                self.pc.inc("bytes_in", nbytes + 4)
                self.pc.inc("frames_in")
                cs = self._conn_stat(conn)
                cs.bytes_in += nbytes + 4
                cs.frames_in += 1
                # recv copies: ONE recv_into fill of the pooled
                # segment per frame — the data-segment slices are
                # views into it now, so the old per-blob
                # re-materialisation is gone; anything outliving the
                # frame books its own copy via _materialize_views
                copytrack.book_pc(self._copy_pc, "recv", nbytes,
                                  copies=1)
                try:
                    self._dispatch(conn, msg, blobs, nbytes, seg)
                except Exception as e:
                    # a poisoned frame (bad blob reference, malformed
                    # control fields) drops THAT frame; the reader —
                    # and with it the session's resync/cleanup path —
                    # must survive it
                    self.log.derr(f"{self.name}: dropping bad frame "
                                  f"({msg.get('type')!r}): {e!r}")
        _reap_writer(conn)
        self._conn_stats.pop(id(conn), None)
        with self._conn_lock:
            self._accepted.discard(conn)
            tids = self._conn_waiters.pop(id(conn), set())
        if tids:
            with self._pending_lock:
                for tid in tids:
                    ev = self._waiters.get(tid)
                    if ev is not None and tid not in self._pending:
                        self._pending[tid] = {
                            "__session_dead__": "connection lost"}
                        ev.set()
        if addr is not None:
            self._on_conn_death(addr, conn)

    def _on_conn_death(self, addr: Addr, conn) -> None:
        with self._conn_lock:
            if self._conns.get(addr) is conn:
                self._conns.pop(addr, None)
        sess = self._out.get(addr)
        if sess is not None:
            with sess.lock:
                sess.synced = False
                dirty = bool(sess.unacked)
            if dirty and self._running:
                threading.Thread(target=self._resync, args=(addr,),
                                 daemon=True).start()

    def _resync(self, addr: Addr) -> None:
        """Reconnect + replay after a dropped lossless connection.
        When every attempt fails the peer is presumed dead: calls
        still waiting on this session fail NOW (their frames stay
        buffered — a later reconnect replays them and dedup keeps
        exactly-once execution)."""
        bo = Backoff(base=0.05, cap=0.5, deadline=3.0)
        for _ in range(8):
            if not self._running:
                return
            try:
                with self._out[addr].lock:
                    self._ensure_synced(addr)
                return
            except (OSError, TimeoutError):
                if not bo.sleep():
                    break
        self._fail_waiters(addr, "peer unreachable after resync")

    def _fail_waiters(self, addr: Addr, why: str) -> None:
        sess = self._out.get(tuple(addr))
        if sess is None:
            return
        with sess.buf_lock:
            tids = list(sess.waiters)
            sess.waiters.clear()
        if not tids:
            return
        with self._pending_lock:
            for tid in tids:
                ev = self._waiters.get(tid)
                if ev is not None and tid not in self._pending:
                    self._pending[tid] = {"__session_dead__": why}
                    ev.set()

    def _conn_stat(self, conn: socket.socket) -> _ConnStats:
        cs = self._conn_stats.get(id(conn))
        if cs is None:
            try:
                peer = "%s:%d" % conn.getpeername()[:2]
            except OSError:
                peer = "?"
            cs = self._conn_stats.setdefault(id(conn),
                                             _ConnStats(peer))
        return cs

    def _send(self, conn: socket.socket, msg: Dict) -> None:
        """Sign-at-wire-time send: frames are stored/buffered unsigned
        (and may hold raw ``bytes`` values); the MAC is computed over
        the lifted control segment + data-segment digests."""
        # stall clock starts BEFORE the fault block: an armed
        # msgr.delay_frame models a slow wire, and the whole point of
        # the meter is that slow wires surface as send stall
        t0 = time.monotonic()
        mutate = None
        close_after = False
        if faults._ACTIVE:  # one bool test when nothing is armed
            if faults.fires("msgr.drop_frame", self.name):
                # a TCP stream never silently loses a frame — wire
                # loss manifests as a dead connection (the `ms inject
                # socket failures` model); the lossless session's
                # unacked buffer replays through the reconnect
                self._hard_close(conn)
                return
            faults.sleep_if("msgr.delay_frame", self.name)
            if faults.fires("msgr.corrupt_frame", self.name):
                mutate = _flip_control_byte
            elif faults.fires("msgr.close_mid_frame", self.name):
                mutate = _truncate_frame
                close_after = True
        w = _sock_writers.get(id(conn))
        depth = len(w.q) if w is not None else 0
        n, joined = _send_frame(conn, msg, self.keyring,
                                mutate=mutate)
        self.pc.inc("bytes_out", n)
        self.pc.inc("frames_out")
        cs = self._conn_stat(conn)
        cs.bytes_out += n
        cs.frames_out += 1
        cs.sends += 1
        if depth:
            self.pc.hist_add("send_queue_depth", depth)
            if depth > cs.q_depth_peak:
                cs.q_depth_peak = depth
        stall = time.monotonic() - t0
        if stall >= _STALL_MIN_S:
            self.pc.tinc("send_stall_time", stall)
            self.pc.inc("send_stalls")
            cs.send_stall_s += stall
            cs.send_stalls += 1
        # send copies: the uncontended path gathers the frame straight
        # from the caller's buffers (sendmsg scatter-gather — zero
        # userspace join); only the contended/fault paths materialise
        # the frame, and exactly that join is booked
        if joined:
            copytrack.book_pc(self._copy_pc, "send", joined,
                              copies=1)
        if faults._ACTIVE and not close_after and \
                faults.fires("msgr.dup_frame", self.name):
            # receiver-side seq dedup (or reply-tid idempotence) must
            # absorb the retransmission
            _send_frame(conn, msg, self.keyring)
        if close_after:
            self._hard_close(conn)

    @nonblocking
    def _dispatch(self, conn: socket.socket, msg: Dict, blobs: list,
                  nbytes: int, seg=None) -> None:
        """Owns ``seg`` — the pooled recv segment every blob view in
        this frame lives in.  ``owned`` tracks the obligation: early
        control paths fall through to the release in ``finally``; the
        handler paths transfer ownership (the fifo entry / the pool
        task releases after the handler returns — views in ``msg``
        are valid exactly that long).  A parse or verify failure
        releases before the error reaches the reader's
        drop-bad-frame log."""
        owned = seg
        try:
            t_rx = time.monotonic()  # dispatch_lat anchor: receipt
            if self.keyring is not None and \
                    not self.keyring.verify(msg, blobs):
                return  # unauthenticated frame: drop (cephx deny)
            msg = _restore_blobs(msg, blobs)
            type_ = msg.get("type", "")
            if type_ == "__reply__":
                # the waiting caller keeps the payload past this
                # frame: stabilize its views NOW (the one deliberate
                # recv-side copy a read reply pays), then the
                # segment can recycle
                payload = _materialize_views(msg.get("payload", {}),
                                             self._copy_pc, "recv")
                with self._pending_lock:
                    ev = self._waiters.get(msg["tid"])  # drop
                    # stragglers
                    if ev is not None:
                        self._pending[msg["tid"]] = payload
                        ev.set()
                return
            if type_ == "__ack__":
                sess = self._out.get(tuple(msg["addr"]))
                if sess is not None and \
                        msg.get("sess") == self.session_id:
                    sess.trim(int(msg["in_seq"]))  # buf_lock only:
                    # an ack must never wait behind a handshake on
                    # this session
                return
            if type_ == "__hello__":
                key = (msg.get("frm", ""), msg.get("sess", ""))
                with self._in_lock:
                    ins = self._in.setdefault(key, _InSession())
                # the handshake reply moves OFF the reader thread
                # (asyncheck BLOCK001): _reply -> _send -> sendall
                # can stall on a backpressured peer socket, and this
                # thread is the one draining EVERY frame on the
                # connection — a wedged hello reply froze acks,
                # replies and dispatch behind it.  The in_seq
                # snapshot is taken above, so a delayed send changes
                # nothing the peer can observe.
                self._pool_submit(self._reply, conn, msg,
                                  {"in_seq": ins.in_seq, "ok": True},
                                  control=True)
                return

            seq = msg.get("_s")
            ins = None
            if seq is not None:
                key = (msg.get("frm", ""), msg.get("_sess", ""))
                with self._in_lock:
                    ins = self._in.setdefault(key, _InSession())
                    dup = seq <= ins.in_seq
                    if not dup:
                        ins.in_seq = seq
                if dup:
                    # duplicate (retransmission or replayed capture):
                    # never re-execute; resend the original reply.
                    # If the original is still being handled on
                    # another thread, wait briefly for its reply to
                    # land in the cache.
                    if msg.get("tid") is not None:
                        self._pool_submit(self._resend_cached, conn,
                                          ins, seq)
                    return

            # handler execution moves OFF the reader thread (the
            # reference's DispatchQueue + fast-dispatch workers,
            # src/msg/DispatchQueue.h): one connection can have many
            # ops in flight — without this, a primary fanning a write
            # out to replicas serializes every other op sharing the
            # connection behind the fan-out's round trips.  Sequenced
            # frames of ORDERED types additionally keep per-session
            # FIFO through a serial lane feeding the pool (below):
            # the quorum layer relies on mon_commit(v) finishing
            # before mon_accept(v+1) starts, and two pool workers
            # racing frames from one peer broke that (spurious
            # non-contiguous nacks → leader abdication churn).
            # Everything else stays fully parallel; per-object order
            # there is owned by PG locks + versions, as in the
            # reference's sharded op queues.
            control = type_ in self._control
            if ins is not None and type_ in self._ordered:
                with self._in_lock:
                    ins.fifo.append((conn, msg, seq, nbytes, t_rx,
                                     seg))
                    owned = None  # the fifo entry holds it now
                    drain = not ins.draining
                    if drain:
                        ins.draining = True
                if drain and not self._pool_submit(
                        self._drain_session, ins, control=control):
                    self._flush_fifo(ins)  # shutdown: nothing will
                    # drain the lane — release its queued segments
            else:
                if self._pool_submit(self._handle, conn, msg, ins,
                                     seq, nbytes, t_rx, seg,
                                     control=control):
                    owned = None  # the pool task releases it
        finally:
            if owned is not None:
                owned.release()

    def _flush_fifo(self, ins: _InSession) -> None:
        """Drop a session's queued frames (pool refused the lane
        worker at shutdown), releasing their pooled segments."""
        with self._in_lock:
            entries = list(ins.fifo)
            ins.fifo.clear()
            ins.draining = False
        for *_rest, seg in entries:
            if seg is not None:
                seg.release()

    def _drain_session(self, ins: _InSession) -> None:
        """Serial lane worker: run one session's queued frames in
        arrival order, then retire.  At most one lane worker per
        session exists (the ``draining`` flag, flipped under
        _in_lock), so frames never reorder within a session."""
        while True:
            with self._in_lock:
                if not ins.fifo:
                    ins.draining = False
                    return
                conn, msg, seq, nbytes, t_rx, seg = ins.fifo.popleft()
            try:
                self._handle(conn, msg, ins, seq, nbytes, t_rx, seg)
            except Exception as e:
                # the lane must survive a poisoned op, or every later
                # frame from this session queues forever
                self.log.derr(f"{self.name}: handler for "
                              f"{msg.get('type')!r} died: {e!r}")

    def _resend_cached(self, conn, ins: _InSession, seq: int) -> None:
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._in_lock:
                cached = ins.replies.get(seq)
            if cached is not None:
                try:
                    self._send(conn, cached)
                except OSError:
                    pass
                return
            time.sleep(0.02)  # fault-ok: bounded 2s poll of the
            # local duplicate-reply cache, not peer retry pacing

    def _pool_submit(self, fn, *args, control: bool = False) -> bool:
        with self._pool_lock:
            if control:
                pool = self._ctl_pool
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = self._ctl_pool = ThreadPoolExecutor(
                        max_workers=4,
                        thread_name_prefix=f"msgr-ctl:{self.name}")
            else:
                pool = self._pool
                if pool is None:
                    from concurrent.futures import ThreadPoolExecutor

                    pool = self._pool = ThreadPoolExecutor(
                        max_workers=16,
                        thread_name_prefix=f"msgr-dispatch:{self.name}")
        try:
            pool.submit(fn, *args)
            return True
        except RuntimeError:
            return False  # shutting down

    def _handle(self, conn: socket.socket, msg: Dict,
                ins: Optional[_InSession], seq, nbytes: int,
                t_rx: Optional[float] = None, seg=None) -> None:
        """``seg`` (when set) is the pooled segment the frame's blob
        views live in — held for the handler's whole execution (a
        handler forwarding a view in a fan-out call blocks until the
        peers reply, so the view stays valid), released on exit."""
        try:
            self._handle_inner(conn, msg, ins, seq, nbytes, t_rx)
        finally:
            if seg is not None:
                seg.release()

    def _handle_inner(self, conn: socket.socket, msg: Dict,
                      ins: Optional[_InSession], seq, nbytes: int,
                      t_rx: Optional[float] = None) -> None:
        type_ = msg.get("type", "")
        ctl = type_ in self._control
        throttle = self.throttles.get(type_)
        if throttle is not None:
            if nbytes > throttle.max:
                # an unsatisfiable get() would wedge this reader thread
                # forever; oversized messages are a protocol error
                self._reply(conn, msg, {"error": "message too large"})
                return
            throttle.get(nbytes)
        try:
            if faults._ACTIVE and faults.partitioned(
                    str(msg.get("frm") or ""), self.name):
                # a directional net.partition covers this sender->
                # receiver pair: the frame never "arrived" — no
                # handler, no reply, no ack; the sender sees the
                # same silence a cut link leaves (its session
                # replays on reconnect, as across a real partition)
                return
            handler = self._handlers.get(type_)
            if handler is None:
                reply = {"error": f"no handler for {type_!r}"}
            else:
                # child span of the sender's call/send span when the
                # frame carries trace context (the server half of the
                # rpc); the no-op span otherwise, so untraced traffic
                # never fills the ring
                with self.tracer.start_span(
                        f"handle:{type_}",
                        child_of=msg.get("trace"),
                        require_parent=True,
                        tags={"frm": msg.get("frm", "")}) as sp:
                    if t_rx is not None:
                        # frame receipt -> handler start: the dispatch
                        # queue wait, split into its own attribution
                        # stage (common/attribution.py) AND the
                        # per-lane wait histogram (the DispatchQueue
                        # saturation signal dump_messenger reads)
                        q_wait = time.monotonic() - t_rx
                        sp.set_tag("q_wait", round(q_wait, 6))
                        cs = self._conn_stat(conn)
                        if ctl:
                            self.pc.hist_add("dispatch_wait_ctl",
                                             q_wait)
                            cs.wait_ctl_s += q_wait
                            cs.wait_ctl_n += 1
                        else:
                            self.pc.hist_add("dispatch_wait_data",
                                             q_wait)
                            cs.wait_data_s += q_wait
                            cs.wait_data_n += 1
                    # watchdog-visible: a handler wedged on a lock or a
                    # peer RPC shows up in dump_blocked with its stack.
                    # Control-lane handlers additionally run as timed
                    # non-blocking scopes (asyncheck): the control lane
                    # is the future event loop's inline lane, so a
                    # handler overrunning asyncheck_loop_budget_ms is
                    # recorded with both-end stack witnesses
                    with watchdog.section(f"{self.name}:{type_}"), (
                            asyncheck.scope(
                                f"handler:{self.name}:{type_}")
                            if ctl else _NULL_CTX):
                        if ctl and faults._ACTIVE:
                            # the --loop-stall drill's armed delay
                            # fires INSIDE the scope, so the runtime
                            # enforcer must name this exact callback
                            faults.sleep_if("msgr.stall_dispatch",
                                            self.name, 0.2)
                        try:
                            reply = handler(msg)
                        except faults.InjectedKill as e:
                            # a fired kill point: the daemon "died"
                            # holding this op — no reply, no ack; the
                            # sender times out and retries, exactly
                            # the crash image a real kill -9 leaves
                            sp.set_tag("error", repr(e))
                            return
                        except Exception as e:
                            sp.set_tag("error", repr(e))
                            reply = {"error": str(e)}
        finally:
            if throttle is not None:
                throttle.put(nbytes)

        frame = None
        if msg.get("tid") is not None:
            frame = {"type": "__reply__", "tid": msg["tid"],
                     "payload": reply}
            try:
                self._send(conn, frame)
            except OSError:
                pass
        if ins is not None:
            if frame is not None:
                # the cache outlives this frame's pooled segment: a
                # reply whose payload references request views must
                # stabilize them before a retransmission seconds
                # from now resends it (booked deliberate copy)
                frame = _materialize_views(frame, self._copy_pc,
                                           "send")
                with self._in_lock:
                    ins.cache_reply(seq, frame)
            else:
                # ack so the sender can trim its unacked buffer —
                # only for fire-and-forget frames: a reply IS the
                # receipt proof for call-type frames (the sender
                # completes that seq on it), so the separate ack
                # frame was pure per-op overhead
                try:
                    self._send(conn, {"type": "__ack__",
                                      "sess": msg.get("_sess"),
                                      "in_seq": seq,
                                      "addr": list(self.addr)})
                except OSError:
                    pass
        if t_rx is not None:
            dt = time.monotonic() - t_rx
            self.pc.hist_add("dispatch_lat", dt)
            self.pc.tinc("dispatch_time", dt)
            cs = self._conn_stat(conn)
            if ctl:
                self.pc.hist_add("dispatch_lat_ctl", dt)
                cs.lat_ctl_s += dt
                cs.lat_ctl_n += 1
            else:
                self.pc.hist_add("dispatch_lat_data", dt)
                cs.lat_data_s += dt
                cs.lat_data_n += 1

    # -- the saturation surface (dump_messenger) -----------------------
    def dump_messenger(self) -> Dict:
        """Per-connection send/dispatch saturation books, worst
        stall first — the `ceph daemon ... dump_messenger` payload.
        Live queue depth/bytes come from the socket's writer queue at
        dump time; the cumulative books from _ConnStats."""
        conns = []
        for cid, cs in list(self._conn_stats.items()):
            entry = cs.dump()
            w = _sock_writers.get(cid)
            q = list(w.q) if w is not None else []
            entry["queue_depth"] = len(q)
            entry["queue_bytes"] = sum(len(o.buf) for o in q)
            conns.append(entry)
        conns.sort(key=lambda c: (c["send_stall_s"],
                                  c["queue_bytes"],
                                  c["bytes_out"]), reverse=True)
        dump = self.pc.dump()
        return {
            "name": self.name,
            "addr": list(self.addr),
            "num_connections": len(conns),
            "connections": conns,
            "totals": {
                "send_stall_s": round(
                    float(dump.get("send_stall_time", 0.0)), 6),
                "send_stalls": int(dump.get("send_stalls", 0)),
                "bytes_in": int(dump.get("bytes_in", 0)),
                "bytes_out": int(dump.get("bytes_out", 0)),
                "frames_in": int(dump.get("frames_in", 0)),
                "frames_out": int(dump.get("frames_out", 0)),
            },
        }

    def wire(self, admin_socket) -> None:
        """Admin-socket surface: dump_messenger beside the daemon's
        optracker/tracer dumps."""
        admin_socket.register(
            "dump_messenger",
            lambda _a: self.dump_messenger(),
            "per-connection send-stall / dispatch-wait books")

    def _reply(self, conn, msg: Dict, payload: Dict) -> None:
        if msg.get("tid") is not None:
            try:
                self._send(conn, {"type": "__reply__",
                                  "tid": msg["tid"],
                                  "payload": payload})
            except OSError:
                pass

    # -- client side ---------------------------------------------------
    def _connect(self, addr: Addr) -> socket.socket:
        addr = tuple(addr)
        with self._conn_lock:
            if self._shut:
                # a background resync racing shutdown() must not dial
                # a fresh connection: it lands AFTER the conn table is
                # cleared, nothing ever closes it, and its reader
                # thread leaks into the next test/runtime
                raise OSError(f"{self.name}: messenger shut down")
            sock = self._conns.get(addr)
            if sock is not None:
                return sock
            sock = socket.create_connection(addr, timeout=5)
            # the 5 s bound is the dial's: left on the socket, it would
            # end the reader (and every call waiting on it) whenever the
            # peer is silent for 5 s, as a slow reply is
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP,
                            socket.TCP_NODELAY, 1)
            self._conns[addr] = sock
            threading.Thread(target=self._reader, args=(sock, addr),
                             daemon=True,
                             name=f"msgr-rd:{self.name}").start()
            return sock

    @staticmethod
    def _hard_close(sock: socket.socket) -> None:
        """shutdown(2) then close: a plain close() is DEFERRED by
        CPython while another thread sits in recv() on the same socket
        object (_io_refs), so the reader would stay blocked on an fd
        nobody can close anymore; SHUT_RDWR tears the connection down
        regardless and wakes the reader with EOF."""
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass
        # the reader's exit also reaps, but accept-side sockets whose
        # reader never started (shutdown mid-accept) come through here
        # too — reap alongside the _conns cleanup, always
        _reap_writer(sock)

    def _drop(self, addr: Addr) -> None:
        with self._conn_lock:
            sock = self._conns.pop(tuple(addr), None)
        if sock is not None:
            self._hard_close(sock)

    def _session(self, addr: Addr) -> _OutSession:
        addr = tuple(addr)
        sess = self._out.get(addr)
        if sess is None:
            sess = self._out.setdefault(addr, _OutSession())
        return sess

    def _raw_call(self, addr: Addr, msg: Dict,
                  timeout: float = 5.0) -> Dict:
        """tid-correlated exchange below the session layer (the
        handshake itself must not be sequenced)."""
        tid = _next_tid()
        msg = dict(msg, tid=tid, frm=self.name)
        deadline = time.monotonic() + timeout
        ev = threading.Event()
        with self._pending_lock:
            self._waiters[tid] = ev
        sock = None
        try:
            sock = self._connect(addr)
            self._bind_waiter(sock, tid)
            self._send(sock, msg)
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(
                    f"{self.name}: no hello reply from {addr}")
            with self._pending_lock:
                rep = self._pending.pop(tid)
            if isinstance(rep, dict) and \
                    "__session_dead__" in rep:  # wire-ok: local pending-table marker, never framed
                raise OSError(f"{self.name}: {addr} "
                              f"{rep['__session_dead__']}")
            return rep
        finally:
            if sock is not None:
                self._unbind_waiter(sock, tid)
            with self._pending_lock:
                self._waiters.pop(tid, None)
                self._pending.pop(tid, None)

    def _bind_waiter(self, sock, tid: str) -> None:
        with self._conn_lock:
            self._conn_waiters.setdefault(id(sock), set()).add(tid)

    def _unbind_waiter(self, sock, tid: str) -> None:
        with self._conn_lock:
            tids = self._conn_waiters.get(id(sock))
            if tids is not None:
                tids.discard(tid)
                if not tids:
                    del self._conn_waiters[id(sock)]

    def _ensure_synced(self, addr: Addr,
                       deadline: Optional[float] = None) -> None:
        """Under the session lock: connect, handshake, replay the
        unacked tail past the peer's in_seq (ProtocolV2 reconnect).
        Replays every buffered frame, so callers must NOT also send
        frames buffered before this ran.  The handshake honors the
        caller's ``deadline``: connect() can succeed into a dying
        peer's accept backlog and then never see a reply, and a
        5-second wait there — under the session lock — once starved a
        leader's lease round long enough to collapse the quorum."""
        sess = self._session(addr)
        sock = self._connect(addr)
        if sess.synced:
            return
        timeout = 5.0 if deadline is None else \
            max(0.05, min(5.0, deadline - time.monotonic()))
        rep = self._raw_call(addr, {"type": "__hello__",
                                    "sess": self.session_id},
                             timeout=timeout)
        peer_in = int(rep.get("in_seq", 0))
        sess.trim(peer_in)
        for frame in sess.pending():
            self._send(sock, frame)
        sess.synced = True

    def _send_sequenced(self, addr: Addr, msg: Dict,
                        timeout: float = 5.0) -> int:
        """Returns the assigned seq (call() completes it on reply).

        Bounded end to end by ``timeout``: the session lock may be
        held for seconds by a background resync handshaking with a
        dead peer, and a caller with its own small deadline (a lease
        round, a heartbeat) must fail fast rather than queue behind
        it — the quorum-collapse class the lockdep/watchdog layer
        exists to catch."""
        sess = self._session(addr)
        deadline = time.monotonic() + timeout
        if not sess.lock.acquire(timeout=timeout):
            raise TimeoutError(f"{self.name}: session to {addr} busy "
                               f"(resync in progress)")
        try:
            sess.out_seq += 1
            seq = sess.out_seq
            needs_reply = msg.get("tid") is not None
            frame = dict(msg, _s=seq, _sess=self.session_id,
                         frm=self.name)
            if not needs_reply:
                # a fire-and-forget frame sits in the unacked buffer
                # past the caller's return, and a reconnect replays
                # it — any view it carries must be stabilized before
                # the caller's segment recycles (booked deliberate
                # copy).  Call frames skip this: the caller blocks
                # until the seq completes, keeping its views valid.
                frame = _materialize_views(frame, self._copy_pc,
                                           "send")
            sess.buffer(seq, frame, needs_reply)
            try:
                if sess.synced:
                    self._send(self._connect(addr), frame)
                else:
                    self._ensure_synced(addr, deadline)  # replays
                    # every buffered frame, this one included
            except (OSError, TimeoutError):
                # one immediate retry on a fresh connection; further
                # healing happens in the background resync
                self._drop(addr)
                sess.synced = False
                try:
                    self._ensure_synced(addr, deadline)
                except (OSError, TimeoutError):
                    if msg.get("tid") is not None:
                        # the call is failing to its caller: a frame
                        # left buffered would replay a dead op after
                        # the peer returns (e.g. a stale pg_temp_set)
                        sess.complete(seq)
                    raise
            return seq
        finally:
            sess.lock.release()

    def send(self, addr: Addr, msg: Dict) -> None:
        """Fire-and-forget.  Lossless: sequenced + replayed across
        reconnects.  Lossy: one silent reconnect attempt.  When an op
        is being traced on this thread the frame carries the span
        context (no-op span — and no wire field — otherwise)."""
        with self.tracer.start_span(
                f"send:{msg.get('type', '?')}", require_parent=True,
                tags={"peer": f"{addr[0]}:{addr[1]}"}) as sp:
            carrier = self.tracer.inject(sp)
            if carrier is not None:
                msg = dict(msg, trace=carrier)
            if self.lossless:
                try:
                    # bounded: a fire-and-forget caller (heartbeat
                    # loop, map pusher) must not wedge behind a dead
                    # session's resync; the unacked buffer owns
                    # delivery anyway
                    self._send_sequenced(addr, msg, timeout=2.0)
                except (OSError, TimeoutError):
                    pass  # unacked buffer + resync own the retry
                return
            for _ in range(2):
                try:
                    self._send(self._connect(addr), msg)
                    return
                except OSError:
                    self._drop(addr)

    def call(self, addr: Addr, msg: Dict,
             timeout: float = 10.0) -> Dict:
        """Request/response correlated by tid.  On a lossless
        messenger the request is sequenced: if the connection drops
        after the peer processed it, the retransmission is deduped and
        the cached reply resent — exactly-once execution.

        Tracing: every call gets a span (a child of this thread's
        active span when one exists, else a new root) and the frame
        carries its context, so the peer's handler span joins the
        same trace."""
        with self.tracer.start_span(
                f"call:{msg.get('type', '?')}",
                tags={"peer": f"{addr[0]}:{addr[1]}"}) as sp:
            carrier = self.tracer.inject(sp)
            if carrier is not None:
                msg = dict(msg, trace=carrier)
            return self._call(addr, msg, timeout)

    def _call(self, addr: Addr, msg: Dict,
              timeout: float = 10.0) -> Dict:
        tid = _next_tid()
        deadline = time.monotonic() + timeout
        seq = None
        sock = None
        sess = self._session(addr) if self.lossless else None
        ev = threading.Event()
        with self._pending_lock:
            self._waiters[tid] = ev
        try:
            if self.lossless:
                with sess.buf_lock:
                    sess.waiters.add(tid)
                seq = self._send_sequenced(addr, dict(msg, tid=tid),
                                           timeout=timeout)
            else:
                smsg = dict(msg, tid=tid, frm=self.name)
                try:
                    sock = self._connect(addr)
                    self._send(sock, smsg)
                except OSError:
                    # stale cached connection (peer restarted): one
                    # fresh reconnect before giving up
                    self._drop(addr)
                    sock = self._connect(addr)
                    self._send(sock, smsg)
                # lossy: no replay behind this call — it dies with
                # its connection instead of waiting out the timeout
                self._bind_waiter(sock, tid)
            if not ev.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(
                    f"{self.name}: no reply from {addr} "
                    f"for {msg['type']}")
            with self._pending_lock:
                rep = self._pending.pop(tid)
            if isinstance(rep, dict) and \
                    "__session_dead__" in rep:  # wire-ok: local pending-table marker, never framed
                # resync gave the peer up: fail now, not at timeout
                raise OSError(f"{self.name}: {addr} "
                              f"{rep['__session_dead__']}")
            return rep
        except OSError:
            self._drop(addr)
            raise
        finally:
            if seq is not None:
                # replied, timed out, or failed: either way this call
                # is over — stop replaying its request
                self._session(addr).complete(seq)
            if sess is not None:
                with sess.buf_lock:
                    sess.waiters.discard(tid)
            if sock is not None:
                self._unbind_waiter(sock, tid)
            with self._pending_lock:
                self._waiters.pop(tid, None)
                self._pending.pop(tid, None)

    def shutdown(self) -> None:
        self._shut = True
        self._running = False
        with self._pool_lock:
            pools = (self._pool, self._ctl_pool)
            self._pool = self._ctl_pool = None
        for pool in pools:
            if pool is not None:
                pool.shutdown(wait=False)
        try:
            self._listener.close()
        except OSError:
            pass
        with self._conn_lock:
            socks = list(self._conns.values()) + list(self._accepted)
            self._conns.clear()
            self._accepted.clear()
        for sock in socks:
            self._hard_close(sock)
        self._conn_stats.clear()
