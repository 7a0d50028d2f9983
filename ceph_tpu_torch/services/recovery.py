"""Recovery-engine support state: helper-load ledger + reservations.

Two small, lock-protected books behind the OSD's pipelined recovery
path (osd_service._run_recovery):

``HelperLedger`` — the per-OSD in-flight ledger the helper-read
fan-out consults to pick the LEAST-LOADED survivor instead of always
reading the first k up shards (the rateless load-balancing analysis,
arXiv:1804.10331: recovery time is dominated by the hottest helper).
Load is this primary's own in-flight helper reads against an OSD plus
the last scheduler depth that OSD reported in a shard_read reply (the
heartbeat/pg-stats-plane feed).  It also keeps the per-object
exclusion table: a helper whose read failed (EIO'd via
``osd.shard_read_eio``, timed out, or returned a stale version) is
excluded from that object's remaining attempts — across recovery
passes, so the next pass does not re-request from the same bad OSD —
with a doubling TTL so a *transient* EIO cannot permanently strand an
object on a small cluster where every survivor eventually
misbehaves once.

``ReservationBook`` — the AsyncReserver-lite (the reference's
local_reserver/remote_reserver pair, osd/scheduler + AsyncReserver.h):
one slot pool of ``osd_max_recovery_ops`` shared by this OSD's own
recovery work and the grants it hands to remote primaries
(``recovery_reserve`` RPC), so a burst of primaries recovering onto
one OSD is bounded and client p99 holds under active recovery.

The port's copy of ``ceph_tpu/services/recovery.py``, on the port's
runtime; it does no device work.
"""

from __future__ import annotations

import time
from typing import Dict, List, Set, Tuple

from ..analysis.lockdep import make_lock

# exclusion TTLs: first failure sidelines a helper for EXCLUDE_BASE_S,
# each repeat doubles up to EXCLUDE_CAP_S (decorrelated enough for a
# toy cluster; a real bad disk keeps re-earning its exclusion)
EXCLUDE_BASE_S = 1.0
EXCLUDE_CAP_S = 30.0

# one in-flight read from this primary weighs as much as this many
# queued ops on the remote scheduler when ranking helpers
INFLIGHT_WEIGHT = 2.0


class HelperLedger:
    """Per-OSD helper-read load + per-object failure exclusions."""

    def __init__(self):
        self._lock = make_lock("osd::rec_ledger")
        self._inflight: Dict[int, int] = {}
        self._remote_load: Dict[int, float] = {}
        # (pool, ps, oid) -> {osd: (expiry_monotonic, ttl)}
        self._excluded: Dict[Tuple, Dict[int, Tuple[float, float]]] = {}

    # -- in-flight / reported load -------------------------------------
    def start(self, osd: int) -> None:
        with self._lock:
            self._inflight[osd] = self._inflight.get(osd, 0) + 1

    def finish(self, osd: int) -> None:
        with self._lock:
            n = self._inflight.get(osd, 0) - 1
            if n > 0:
                self._inflight[osd] = n
            else:
                self._inflight.pop(osd, None)

    def note_load(self, osd: int, load: float) -> None:
        """A shard_read reply carried the helper's scheduler depth."""
        with self._lock:
            self._remote_load[osd] = float(load)

    def load(self, osd: int) -> float:
        with self._lock:
            return (self._inflight.get(osd, 0) * INFLIGHT_WEIGHT
                    + self._remote_load.get(osd, 0.0))

    # -- per-object exclusions -----------------------------------------
    def exclude(self, key: Tuple, osd: int) -> None:
        """Sideline ``osd`` for object ``key``; repeats double the
        TTL (capped), so the exclusion outlives the next recovery
        passes while a genuinely transient fault ages out."""
        now = time.monotonic()
        with self._lock:
            ent = self._excluded.setdefault(key, {})
            prev = ent.get(osd)
            ttl = EXCLUDE_BASE_S if prev is None \
                else min(EXCLUDE_CAP_S, prev[1] * 2.0)
            ent[osd] = (now + ttl, ttl)

    def excluded(self, key: Tuple) -> Set[int]:
        """Currently-excluded OSDs for an object (expired entries are
        pruned in place)."""
        now = time.monotonic()
        with self._lock:
            ent = self._excluded.get(key)
            if not ent:
                return set()
            dead = [o for o, (exp, _ttl) in ent.items() if exp <= now]
            for o in dead:
                del ent[o]
            if not ent:
                self._excluded.pop(key, None)
                return set()
            return set(ent)

    def dump(self) -> Dict:
        with self._lock:
            return {
                "inflight": dict(self._inflight),
                "remote_load": dict(self._remote_load),
                "excluded": {repr(k): sorted(v)
                             for k, v in self._excluded.items()},
            }


class ReservationBook:
    """One recovery slot pool shared by local work and remote grants
    (the AsyncReserver local+remote pair, collapsed: both sides draw
    from ``osd_max_recovery_ops``)."""

    def __init__(self, slots: int):
        self._lock = make_lock("osd::rec_reserve")
        self._slots = max(1, int(slots))
        self._held = 0

    def try_acquire(self) -> bool:
        with self._lock:
            if self._held < self._slots:
                self._held += 1
                return True
            return False

    def release(self) -> None:
        with self._lock:
            if self._held > 0:
                self._held -= 1

    @property
    def held(self) -> int:
        with self._lock:
            return self._held

    @property
    def slots(self) -> int:
        return self._slots
