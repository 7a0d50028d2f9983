"""Subsystem logging with a crash ring buffer.

The port's copy of ``ceph_tpu/common/log.py``, on the port's lockdep.
The role of src/log/Log.cc and SubsystemMap.h: every subsystem has a
level; ``dout(subsys, level)`` gating is ``logger.dout(level)`` on a
per-subsystem logger; the most recent N entries (at any level, even
suppressed ones) are kept in a ring that ``dump_recent`` replays.
"""

from __future__ import annotations

import collections
import sys
import time
from typing import Deque, Dict, Optional, Tuple

from ..analysis.lockdep import make_lock

_Entry = Tuple[float, str, int, str]  # (stamp, subsys, level, message)


class LogCore:
    """Process-wide sink: level gating + the recent-entry ring."""

    def __init__(self, max_recent: int = 500, stream=None):
        self.levels: Dict[str, int] = {}
        self.max_recent = max_recent
        self._recent: Deque[_Entry] = collections.deque(
            maxlen=max_recent)
        self._lock = make_lock("log::core")
        self.stream = stream if stream is not None else sys.stderr

    def set_level(self, subsys: str, level: int) -> None:
        self.levels[subsys] = level

    def get_level(self, subsys: str) -> int:
        return self.levels.get(subsys, 0)

    def submit(self, subsys: str, level: int, message: str) -> None:
        entry = (time.time(), subsys, level, message)
        with self._lock:
            self._recent.append(entry)
        if level <= self.get_level(subsys):
            self.stream.write(self.format(entry) + "\n")

    @staticmethod
    def format(entry: _Entry) -> str:
        stamp, subsys, level, message = entry
        return f"{stamp:.6f} {subsys} {level} : {message}"

    def dump_recent(self, stream=None) -> int:
        """Replay the ring (Log::dump_recent, the crash handler path).
        Returns entries written."""
        out = stream if stream is not None else self.stream
        with self._lock:
            entries = list(self._recent)
        out.write(f"--- begin dump of recent {len(entries)} log "
                  f"entries ---\n")
        for e in entries:
            out.write(self.format(e) + "\n")
        out.write("--- end dump of recent events ---\n")
        return len(entries)


_core: Optional[LogCore] = None


def core() -> LogCore:
    global _core
    if _core is None:
        _core = LogCore()
    return _core


class SubsysLogger:
    """``dout(level) << ...`` as ``log.dout(level, msg)``."""

    def __init__(self, subsys: str, core_: Optional[LogCore] = None):
        self.subsys = subsys
        self.core = core_ or core()

    def dout(self, level: int, message: str) -> None:
        self.core.submit(self.subsys, level, message)

    def derr(self, message: str) -> None:
        self.core.submit(self.subsys, -1, message)

    def enabled(self, level: int) -> bool:
        return level <= self.core.get_level(self.subsys)


def getLogger(subsys: str) -> SubsysLogger:
    return SubsysLogger(subsys)
