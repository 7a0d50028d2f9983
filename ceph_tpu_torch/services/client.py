"""Client — the librados/Objecter analogue.

Placement is CLIENT-SIDE and stateless, exactly as in the reference
(Objecter::_calc_target, src/osdc/Objecter.cc:2688): the client holds
its own OSDMap copy, computes object→PG→OSD mappings locally
(pg_to_up_acting_osds), EC-encodes on write and fans shards out to the
up set positionally; reads gather any k shards and decode.  On a stale
map (peer down / remapped), it refreshes from the mon and retries —
the map-epoch retry loop every RADOS op runs.

The port's copy of ``ceph_tpu/services/client.py``.  Its EC codes are
built on the client's ``device`` (the card unless the caller asks for
the CPU), so a degraded read's decode is a K1 or K3 launch; the object
comes back to the host in one copy.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..analysis.lockdep import make_rlock
from ..common.backoff import Backoff
from ..common.op_tracker import OpTracker
from ..common.perf_counters import collection
from ..common.tracing import Tracer
from ..common.version import make_version
from ..msg.messenger import Addr, Messenger
from ..osdmap.osdmap import OSDMap, POOL_TYPE_ERASURE
from ..ec.registry import profile_factory


class ObjectNotFound(KeyError):
    """Every reachable shard holder answered ENOENT — the object does
    not exist (distinct from transient unreachability, which raises
    TimeoutError/OSError and is retried)."""


class AioCompletion:
    """librados ``rados_completion_t`` analogue: handed out by
    ``aio_put``/``aio_write``; ``wait()`` re-raises the op's failure
    on the caller's thread."""

    __slots__ = ("_done", "error")

    def __init__(self):
        self._done = threading.Event()
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self._done.wait(timeout):
            raise TimeoutError("aio op still in flight")
        if self.error is not None:
            raise self.error


def object_to_ps(oid: str) -> int:
    """object name -> placement seed.  The reference uses
    ceph_str_hash_rjenkins (object_locator_to_pg); any fixed 32-bit
    hash yields the same placement *semantics* — this one is
    sha256-low32, framework-defined and stable."""
    return int.from_bytes(
        hashlib.sha256(oid.encode()).digest()[:4], "little")


from .map_follower import MapFollower


class Client(MapFollower):
    def __init__(self, name: str, mon_addr: Addr,
                 host: str = "127.0.0.1", keyring=None, ctx=None,
                 device="cuda"):
        self.name = name
        # where this client's EC codes live (ec/registry.factory)
        self.device = device
        self.ctx = ctx  # optional Context: librados' own admin socket
        # role — perf dump / dump_tracing / dump_ops_in_flight for the
        # CLIENT side of an op, polled by the telemetry tool
        self._init_mons(mon_addr)  # one addr or the quorum list
        if ctx is not None:
            self.tracer = ctx.tracer
            self.pc = ctx.perf.create(f"client.{name}")
        else:
            self.tracer = Tracer(f"client.{name}")
            self.pc = collection().create(f"client.{name}")
        for key in ("ops_put", "ops_get", "ops_write", "ops_delete",
                    "op_errors", "ops_aio_put", "ops_aio_write"):
            self.pc.add_u64_counter(key)
        self.pc.add_histogram("op_lat")
        self.pc.add_time("op_time")
        # in-flight window occupancy at each aio submit — proves the
        # pipeline actually keeps the OSD queues full
        self.pc.add_histogram("aio_depth", min_value=1)
        # -- pipelined I/O (the librados aio_* window) ---------------
        from ..common.throttle import Throttle

        window = (ctx.conf["client_aio_window"] if ctx is not None
                  else 16)
        self._aio_window = max(1, int(window))
        self._aio_throttle = Throttle(f"client-aio-{name}",
                                      self._aio_window)
        self._aio_pool = None  # lazy: sync-only clients never pay it
        self._aio_inflight: set = set()
        self.optracker = OpTracker(
            history_slow_threshold=ctx.conf["osd_op_complaint_time"]
            if ctx is not None else 0.5)
        if ctx is not None and ctx.conf["admin_socket"]:
            sock = ctx.start_admin_socket()
            self.optracker.wire(sock)
            self.tracer.wire(sock)
        self.msgr = Messenger(f"client.{name}", host, 0,
                              keyring=keyring, tracer=self.tracer,
                              perf=ctx.perf if ctx is not None
                              else None)
        # map pushes on the control lane: a client retrying ops into a
        # dead primary must still learn the new map promptly
        self.msgr.register("map_update", self._h_map_update,
                           control=True)
        self.msgr.register("map_inc", self._h_map_inc, control=True)
        self.msgr.register("watch_notify", self._h_watch_notify)
        # (pool, oid) -> callback; re-registered with the (possibly
        # new) primary on every map change, like librados re-watch
        self._watches: Dict[tuple, object] = {}
        self.msgr.start()
        self.map: Optional[OSDMap] = None
        self.epoch = 0
        self.osd_addrs: Dict[int, Addr] = {}
        self.ec_profiles: Dict[str, Dict[str, str]] = {}
        self._codes: Dict[str, object] = {}
        self._lock = make_rlock("client::state")
        self._install_map(self.subscribe_all(f"client.{name}"))

    def shutdown(self) -> None:
        with self._lock:
            pool, self._aio_pool = self._aio_pool, None
        if pool is not None:
            # no wait: in-flight aio ops fail fast once the messenger
            # drops its sockets below; their workers then exit
            pool.shutdown(wait=False)
        self.msgr.shutdown()
        if self.ctx is not None:
            self.ctx.shutdown()

    # -- pipelined I/O (aio_put/aio_write/flush) -----------------------
    def aio_put(self, pool_id: int, oid: str, data: bytes,
                retries: int = 3,
                on_complete=None) -> AioCompletion:
        """Async ``put`` with a bounded in-flight window: blocks only
        while the window (``client_aio_window``, default 16) is full,
        so callers keep the OSD queues full instead of ping-ponging
        one op at a time.  Durability/ack semantics are ``put``'s —
        the completion fires when the primary acked the write.
        ``on_complete(comp)`` runs on the worker thread right after."""
        return self._aio_submit("put", on_complete, self.put,
                                pool_id, oid, bytes(data), retries)

    def aio_write(self, pool_id: int, oid: str, offset: int,
                  data: bytes, retries: int = 3,
                  on_complete=None) -> AioCompletion:
        """Async partial ``write`` under the same in-flight window."""
        return self._aio_submit("write", on_complete, self.write,
                                pool_id, oid, offset, bytes(data),
                                retries)

    def _aio_submit(self, kind: str, on_complete, fn,
                    *args) -> AioCompletion:
        self._aio_throttle.get()  # the bounded window (backpressure)
        comp = AioCompletion()
        with self._lock:
            pool = self._aio_pool
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = self._aio_pool = ThreadPoolExecutor(
                    max_workers=self._aio_window,
                    thread_name_prefix=f"aio:{self.name}")
            self._aio_inflight.add(comp)
        self.pc.hist_add("aio_depth",
                         self._aio_throttle.get_current())
        self.pc.inc(f"ops_aio_{kind}")

        def run():
            try:
                fn(*args)
            except BaseException as e:
                comp.error = e
            finally:
                with self._lock:
                    self._aio_inflight.discard(comp)
                self._aio_throttle.put()
                comp._done.set()
                if on_complete is not None:
                    try:
                        on_complete(comp)
                    except Exception:
                        pass  # a callback bug must not kill the pool

        try:
            pool.submit(run)
        except RuntimeError:  # racing shutdown
            with self._lock:
                self._aio_inflight.discard(comp)
            self._aio_throttle.put()
            comp.error = OSError(f"client.{self.name} shut down")
            comp._done.set()
        return comp

    def flush(self, timeout: float = 60.0) -> None:
        """Wait for every outstanding aio op (librados
        rados_aio_flush): returns once the window is empty; re-raises
        the FIRST failed op's error after all have settled."""
        deadline = time.monotonic() + timeout
        with self._lock:
            comps = list(self._aio_inflight)
        first: Optional[BaseException] = None
        for c in comps:
            try:
                c.wait(max(0.0, deadline - time.monotonic()))
            except TimeoutError as e:
                if not c.done():
                    raise  # the flush window itself expired
                if first is None:  # the OP failed with TimeoutError
                    first = e
            except BaseException as e:
                if first is None:
                    first = e
        self._aio_throttle.wait_until_drained(
            max(0.0, deadline - time.monotonic()))
        if first is not None:
            raise first

    # -- op instrumentation (the librados op latency surface) ----------
    @contextlib.contextmanager
    def _op(self, kind: str, pool_id: int, oid: str):
        """Root span + tracked op + latency counters around one client
        op (retries included — the latency a caller actually sees)."""
        t0 = time.monotonic()
        with self.tracer.start_span(
                f"client.{kind}",
                tags={"pool": pool_id, "oid": oid}) as span:
            with self.optracker.create(
                    "client_op", f"{kind} {pool_id}/{oid}") as op:
                try:
                    yield span, op
                except BaseException:
                    self.pc.inc("op_errors")
                    raise
                finally:
                    dt = time.monotonic() - t0
                    self.pc.hist_add("op_lat", dt)
                    self.pc.tinc("op_time", dt)
        self.pc.inc(f"ops_{kind}")

    def _retry_backoff(self) -> Backoff:
        """One jittered-backoff budget per op: retry pacing grows
        decorrelated-exponentially (no retry storms when a primary
        dies under N clients) and the TOTAL sleep across retries is
        bounded by ``client_retry_deadline`` — once spent, the op
        re-raises its last error instead of pacing another attempt."""
        dl = (self.ctx.conf["client_retry_deadline"]
              if self.ctx is not None else 10.0)
        return Backoff(base=0.1, cap=1.0, deadline=dl)

    # -- map -----------------------------------------------------------
    def _h_map_update(self, msg: Dict) -> None:
        self._install_map(msg["payload"])
        return None

    def refresh_map(self) -> None:
        self._install_map(self.mon_call({"type": "get_map"}))

    def _code_for(self, pool):
        if pool.pool_type != POOL_TYPE_ERASURE:
            return None
        name = pool.erasure_code_profile
        code = self._codes.get(name)
        if code is None:
            code = profile_factory(dict(self.ec_profiles[name]),
                                   device=self.device)
            self._codes[name] = code
        return code

    def _up(self, pool_id: int, oid: str):
        """Route to the ACTING set (pg_temp overlay included): during
        backfill the acting members hold the data and take the IO —
        the serving-continuity contract of peering (OSDMap.cc:2590)."""
        pool = self.map.pools[pool_id]
        ps = object_to_ps(oid) % pool.pg_num
        up, _p, acting, _ap = self.pg_up_acting(pool_id, ps)
        return pool, ps, (acting if acting else up)

    # -- data path -------------------------------------------------------
    def put(self, pool_id: int, oid: str, data: bytes,
            retries: int = 3) -> None:
        """EVERY write routes through the PG primary (the reference
        sends all ops to the primary, Objecter::_calc_target) — ONE
        client round trip; the primary stamps the version under the
        PG lock (eversion_t at the primary: immune to client clock
        skew) and fans replicas/shards out in parallel."""
        with self._op("put", pool_id, oid) as (_span, op):
            bo = self._retry_backoff()
            for attempt in range(retries):
                v = make_version(self.epoch)  # proposal; primary may
                # bump
                try:
                    # inside the retry loop: a freshly-created pool
                    # may be a map epoch away (a peon served the
                    # refresh before applying the commit) — KeyError
                    # retries like any stale-map condition
                    pool, ps, up = self._up(pool_id, oid)
                    code = self._code_for(pool)
                    if code is None:
                        req = {"type": "rep_write", "pool": pool_id,
                               "ps": ps, "oid": oid,
                               "epoch": self.epoch,
                               "data": bytes(data), "v": v}
                    else:
                        req = {"type": "ec_write", "pool": pool_id,
                               "ps": ps, "oid": oid, "offset": 0,
                               "epoch": self.epoch,
                               "data": bytes(data), "v": v,
                               "full": True}
                    prim = self._first_reachable(up)
                    if prim is None:
                        raise TimeoutError("no reachable primary")
                    got = self.msgr.call(self.osd_addrs[prim], req,
                                         timeout=20)
                    if not got.get("ok") and \
                            got.get("error") == "not primary" and \
                            got.get("primary") in self.osd_addrs:
                        got = self.msgr.call(
                            self.osd_addrs[got["primary"]],
                            dict(req), timeout=20)
                    if not got.get("ok"):
                        raise OSError(f"put via osd.{prim}: {got}")
                    return
                except (TimeoutError, OSError, KeyError):
                    if attempt + 1 == retries:
                        raise
                    op.mark_event(f"retry {attempt + 1}")
                    if not bo.sleep():
                        raise  # retry-sleep budget exhausted
                    self.refresh_map()

    def get(self, pool_id: int, oid: str, retries: int = 3,
            notfound_retries: int = 2) -> bytes:
        """``notfound_retries`` covers the read-races-backfill window:
        a just-remapped up set answers ENOENT for an object that exists
        on the old holders until recovery copies it over.  Callers that
        expect sparse misses (image pieces, existence probes) pass 0
        for fast definitive ENOENT."""
        nf_left = notfound_retries
        transient_left = retries - 1  # separate budgets: an ENOENT
        # retry must never convert into OSError('unreachable') when the
        # miss is definitive — callers branch on ObjectNotFound
        with self._op("get", pool_id, oid) as (_span, op):
            bo = self._retry_backoff()
            while True:
                try:
                    pool, ps, up = self._up(pool_id, oid)
                    code = self._code_for(pool)
                    if code is None:
                        return self._read_replicated(pool_id, ps, oid,
                                                     up)
                    return self._read_ec(pool_id, ps, oid, up, code)
                except ObjectNotFound:
                    if nf_left <= 0 or not bo.sleep():
                        raise
                    nf_left -= 1
                except (TimeoutError, OSError, KeyError):
                    if transient_left <= 0 or not bo.sleep():
                        raise
                    transient_left -= 1
                op.mark_event("retry")
                self.refresh_map()

    def _read_replicated(self, pool_id, ps, oid, up) -> bytes:
        """Version-aware: while divergent histories are still
        reconciling, replicas can disagree — the highest-version copy
        is the acked latest write, so gather all answers and keep it."""
        last: Exception = OSError("empty up set")
        enoent = 0
        reachable = 0
        best = None
        best_v = ""
        agree = 0
        for osd in up:
            try:
                got = self.msgr.call(
                    self.osd_addrs[osd],
                    {"type": "shard_read", "pool": pool_id, "ps": ps,
                     "oid": oid, "shard": 0}, timeout=5)
            except (TimeoutError, OSError, KeyError) as e:
                last = e
                continue
            reachable += 1
            if "data" in got:
                v = got.get("v") or ""
                if best is None or v > best_v:
                    best = bytes(got["data"])[:got["size"]]
                    best_v = v
                    agree = 1
                elif v == best_v:
                    agree += 1
                # two copies agreeing on the newest version seen is
                # proof enough of freshness — the healthy path stops
                # after 2 RPCs instead of querying every replica
                if agree >= 2:
                    return best
            elif got.get("error") == "enoent":
                enoent += 1
        if best is not None:
            return best
        if reachable and enoent == reachable:
            raise ObjectNotFound(oid)
        raise last

    def write(self, pool_id: int, oid: str, offset: int,
              data: bytes, retries: int = 3) -> None:
        """Partial (offset) write.  EC pools: a primary-coordinated
        read-merge-encode op (the ECBackend start_rmw flow) — the
        client sends ONE ec_write to the PG primary, which serializes
        it under the PG lock.  Replicated pools: client-side RMW over
        put (last-writer-wins at object granularity, like the
        reference's replicated offset write under a single client)."""
        with self._op("write", pool_id, oid) as (_span, op):
            bo = self._retry_backoff()
            for attempt in range(retries):
                try:
                    pool, ps, up = self._up(pool_id, oid)
                    code = self._code_for(pool)
                    if code is None:
                        try:
                            base = self.get(pool_id, oid,
                                            notfound_retries=0)
                        except ObjectNotFound:
                            base = b""
                        size = max(len(base), offset + len(data))
                        buf = bytearray(size)
                        buf[:len(base)] = base
                        buf[offset:offset + len(data)] = data
                        self.put(pool_id, oid, bytes(buf))
                        return
                    # same liveness rule as the server's primary
                    # check: first UP member, else the op targets a
                    # dead daemon the real primary would skip
                    prim = self._first_reachable(up)
                    if prim is None:
                        raise TimeoutError("no reachable primary")
                    v = make_version(self.epoch)
                    got = self.msgr.call(
                        self.osd_addrs[prim],
                        {"type": "ec_write", "pool": pool_id,
                         "ps": ps, "oid": oid, "offset": offset,
                         "data": bytes(data), "v": v}, timeout=15)
                    if got.get("ok"):
                        return
                    if got.get("error") == "not primary" and \
                            got.get("primary") in self.osd_addrs:
                        got = self.msgr.call(
                            self.osd_addrs[got["primary"]],
                            {"type": "ec_write", "pool": pool_id,
                             "ps": ps, "oid": oid, "offset": offset,
                             "data": bytes(data), "v": v},
                            timeout=15)
                        if got.get("ok"):
                            return
                    raise OSError(f"ec_write via osd.{prim}: {got}")
                except (TimeoutError, OSError, KeyError):
                    if attempt + 1 == retries:
                        raise
                    op.mark_event(f"retry {attempt + 1}")
                    if not bo.sleep():
                        raise  # retry-sleep budget exhausted
                    self.refresh_map()

    def _first_reachable(self, up):
        """The routing invariant: first up, addressable, non-NONE
        member — the op target every primary-coordinated path uses."""
        return next((o for o in up
                     if o >= 0 and o in self.osd_addrs
                     and self.map.is_up(o)), None)

    # -- watch/notify (librados rados_watch/rados_notify) --------------
    def _primary_of(self, pool_id: int, oid: str):
        pool, ps, up = self._up(pool_id, oid)
        prim = self._first_reachable(up)
        if prim is None:
            raise TimeoutError(f"no reachable primary for {oid}")
        return ps, prim

    def watch(self, pool_id: int, oid: str, callback) -> None:
        """``callback(oid, payload, notifier)`` runs on every notify.
        The registration follows the PG primary across map changes."""
        with self._lock:
            self._watches[(pool_id, oid)] = callback
        self._register_watch(pool_id, oid)

    def _register_watch(self, pool_id: int, oid: str) -> None:
        ps, prim = self._primary_of(pool_id, oid)
        self.msgr.call(self.osd_addrs[prim],
                       {"type": "watch", "pool": pool_id, "ps": ps,
                        "oid": oid, "watcher": self.name,
                        "addr": list(self.msgr.addr)}, timeout=5)

    def unwatch(self, pool_id: int, oid: str) -> None:
        with self._lock:
            self._watches.pop((pool_id, oid), None)
        try:
            ps, prim = self._primary_of(pool_id, oid)
            self.msgr.call(self.osd_addrs[prim],
                           {"type": "unwatch", "pool": pool_id,
                            "ps": ps, "oid": oid,
                            "watcher": self.name}, timeout=5)
        except (TimeoutError, OSError, KeyError):
            pass  # the primary prunes dead watchers on notify anyway

    def notify(self, pool_id: int, oid: str, payload,
               timeout: float = 5.0) -> Dict:
        """Returns {"acks": [names], "missed": [names]}."""
        ps, prim = self._primary_of(pool_id, oid)
        return self.msgr.call(
            self.osd_addrs[prim],
            {"type": "notify", "pool": pool_id, "ps": ps,
             "oid": oid, "payload": payload, "timeout": timeout},
            timeout=timeout + 5.0)

    def _h_watch_notify(self, msg: Dict) -> Dict:
        with self._lock:
            cb = self._watches.get((msg["pool"], msg["oid"]))
        if cb is None:
            return {"ok": False}
        try:
            cb(msg["oid"], msg.get("payload"), msg.get("notifier"))
        except Exception:
            return {"ok": False}
        return {"ok": True}

    def _post_map_install(self) -> None:
        """Re-watch on every epoch: the primary may have moved."""
        with self._lock:
            watches = list(self._watches)
        if not watches:
            return

        def rewatch():
            for pool_id, oid in watches:
                try:
                    self._register_watch(pool_id, oid)
                except (TimeoutError, OSError, KeyError):
                    pass  # next epoch retries

        threading.Thread(target=rewatch, daemon=True).start()

    def delete(self, pool_id: int, oid: str, retries: int = 3) -> None:
        """Tombstoned delete: peering propagates it over older writes
        (the reference's log-entry DELETE semantics)."""
        v = make_version(self.epoch)
        with self._op("delete", pool_id, oid) as (_span, op):
            bo = self._retry_backoff()
            for attempt in range(retries):
                try:
                    pool, ps, up = self._up(pool_id, oid)
                    for osd in {o for o in up
                                if o >= 0 and o in self.osd_addrs}:
                        got = self.msgr.call(
                            self.osd_addrs[osd],
                            {"type": "obj_delete", "pool": pool_id,
                             "ps": ps, "oid": oid, "v": v,
                             "restamp": True}, timeout=10)
                        if not got.get("ok"):
                            raise OSError(f"obj_delete on osd.{osd}: "
                                          f"{got}")
                    return
                except (TimeoutError, OSError, KeyError):
                    if attempt + 1 == retries:
                        raise
                    op.mark_event(f"retry {attempt + 1}")
                    if not bo.sleep():
                        raise  # retry-sleep budget exhausted
                    self.refresh_map()

    def _read_ec(self, pool_id, ps, oid, up, code) -> bytes:
        """Gather any k shards (degraded reads ride the same path the
        reference's objects_read_and_reconstruct does).

        Chunks from different writes never decode together, so shards
        group by version and the NEWEST version with >= k chunks wins:
        a torn higher-version write (partially landed, never acked —
        peering will roll it back) must not shadow the last acked
        state."""
        k = code.get_data_chunk_count()
        m = code.get_chunk_count() - k
        by_ver: Dict[str, Dict[int, np.ndarray]] = {}
        sizes: Dict[str, int] = {}
        enoent = 0
        reachable = 0
        for pos, osd in enumerate(up):
            done = any(len(c) >= k for c in by_ver.values())
            # Early exit is only sound when m < k: an acked write
            # covers >= k positions, so at most m stale shards exist
            # and k stale chunks cannot assemble without surfacing at
            # least one newer shard (which un-satisfies the newest-
            # seen-is-decodable condition).  With m >= k a reader
            # could decode k stale shards before probing any position
            # the newest acked write landed on — probe them all.
            if done and m < k and max(by_ver) == max(
                    (v for v, c in by_ver.items() if len(c) >= k)):
                break  # the newest version seen is already decodable
            try:
                got = self.msgr.call(
                    self.osd_addrs[osd],
                    {"type": "shard_read", "pool": pool_id, "ps": ps,
                     "oid": oid, "shard": pos}, timeout=5)
            except (TimeoutError, OSError, KeyError):
                continue
            reachable += 1
            if "data" in got:
                v = got.get("v") or ""
                by_ver.setdefault(v, {})[pos] = np.frombuffer(
                    bytes(got["data"]), np.uint8)
                sizes[v] = got["size"]
            elif got.get("error") == "enoent":
                enoent += 1
        decodable = [v for v, c in by_ver.items() if len(c) >= k]
        if not decodable:
            if reachable and enoent == reachable:
                raise ObjectNotFound(oid)
            have = max((len(c) for c in by_ver.values()), default=0)
            raise TimeoutError(
                f"only {have}/{k} shards reachable for {oid}")
        best = max(decodable)
        data = code.decode_concat(by_ver[best])[:sizes[best]]
        return data.cpu().numpy().tobytes()
