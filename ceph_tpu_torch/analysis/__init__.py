"""Correctness analysis of the port: lockdep, the stall watchdog,
kernel contracts and the host-sync lint.

``contracts`` and ``lint_torch`` are not imported here: import them
explicitly (``contracts`` builds codes and maps when it verifies).
"""

from .lockdep import (DLock, DRLock, enable, enabled, make_lock,
                      make_rlock, violations)
from .watchdog import Watchdog, dump_blocked, section, start_global

__all__ = ["DLock", "DRLock", "enable", "enabled", "make_lock",
           "make_rlock", "violations", "Watchdog", "dump_blocked",
           "section", "start_global"]
