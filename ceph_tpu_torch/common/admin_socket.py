"""Admin socket — the unix-socket command/introspection plane.

The port's copy of ``ceph_tpu/common/admin_socket.py``.

The role of src/common/admin_socket.{h,cc} (AdminSocket,
admin_socket.h:105): a daemon binds a unix socket; ``ceph daemon
<name> <cmd>`` sends a JSON request line and reads a JSON reply.
Commands are registered with hooks; every daemon gets the built-ins
(help, perf dump, config show/set, log dump).

Protocol: one JSON object per connection — ``{"prefix": "<command>",
...args}`` in, JSON payload out (newline-terminated).
"""

from __future__ import annotations

import io
import json
import os
import socket
import threading
from typing import Callable, Dict, Optional

Hook = Callable[[Dict], object]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._hooks: Dict[str, Hook] = {}
        self._descs: Dict[str, str] = {}
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self.errors = 0  # serve-loop faults (see _serve)
        self.last_error: Optional[str] = None
        self.register("help", lambda _a: dict(self._descs),
                      "list registered commands")

    def register(self, prefix: str, hook: Hook,
                 desc: str = "") -> None:
        self._hooks[prefix] = hook
        self._descs[prefix] = desc

    # -- server side --------------------------------------------------
    def start(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        self._running = True
        self._thread = threading.Thread(target=self._serve,
                                        daemon=True,
                                        name=f"admin:{self.path}")
        self._thread.start()

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                with conn:
                    data = b""
                    while not data.endswith(b"\n"):
                        got = conn.recv(65536)
                        if not got:
                            break
                        data += got
                    reply = self._dispatch(data.decode() or "{}")
                    conn.sendall(reply.encode() + b"\n")
            except Exception as e:
                # one bad client connection must not kill the serve
                # loop — but never vanish silently either (the
                # swallowed-thread-death lint class): keep the last
                # error inspectable
                self.errors += 1
                self.last_error = repr(e)

    def _dispatch(self, line: str) -> str:
        try:
            req = json.loads(line)
            prefix = req.get("prefix", "")
            hook = self._hooks.get(prefix)
            if hook is None:
                return json.dumps(
                    {"error": f"unknown command {prefix!r}",
                     "have": sorted(self._hooks)})
            return json.dumps(hook(req))
        except Exception as e:
            return json.dumps({"error": str(e)})

    def shutdown(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    # -- client side (the `ceph daemon` role) --------------------------
    @staticmethod
    def request(path: str, prefix: str, timeout: float = 5.0,
                **args) -> object:
        with socket.socket(socket.AF_UNIX,
                           socket.SOCK_STREAM) as sock:
            sock.settimeout(timeout)
            sock.connect(path)
            sock.sendall(json.dumps(
                {"prefix": prefix, **args}).encode() + b"\n")
            data = b""
            while not data.endswith(b"\n"):
                got = sock.recv(65536)
                if not got:
                    break
                data += got
        return json.loads(data.decode())


def wire_defaults(sock: AdminSocket, config=None, perf=None,
                  logcore=None) -> None:
    """Register the built-in command set every daemon exposes."""
    from ..analysis.watchdog import dump_blocked

    # the stall-watchdog surface (analysis/watchdog.py): locks held /
    # handlers running past ?threshold seconds + all-thread stacks
    sock.register(
        "dump_blocked",
        lambda a: dump_blocked(
            threshold=float(a.get("threshold", 0.0)),
            with_stacks=bool(a.get("stacks", True))),
        "locks held and handlers stalled beyond a threshold, with "
        "per-thread stacks")
    if perf is not None:
        def _perf_dump(a):
            # the daemon's own collection, merged over the
            # PROCESS-GLOBAL library counters (ec.engine,
            # crush.mapper, crush.scalar — kernels shared by every
            # in-process daemon, perf_counters.collection()); the
            # daemon's loggers win on a name collision
            from .perf_counters import collection

            merged = dict(collection().dump())
            merged.update(perf.dump())
            lg = a.get("logger")
            if lg:
                return {lg: merged.get(lg, {})}
            return merged

        sock.register("perf dump", _perf_dump,
                      "dump perf counters (daemon + shared library "
                      "kernels; ?logger= filters)")
    if config is not None:
        sock.register("config show", lambda _a: config.show(),
                      "dump config options with sources")

        def _set(a):
            config.set(a["key"], a["value"])
            return {"success": f"{a['key']} = {config.get(a['key'])}"}

        sock.register("config set", _set, "override an option")
        sock.register(
            "config get",
            lambda a: {a["key"]: config.get(a["key"])},
            "read one option")
    if logcore is not None:
        def _log_dump(_a):
            buf = io.StringIO()
            n = logcore.dump_recent(buf)
            return {"entries": n, "dump": buf.getvalue()}

        sock.register("log dump", _log_dump,
                      "replay the recent-entry ring buffer")
