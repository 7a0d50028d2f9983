"""Per-op byte-copy ledger — counting every hot-path host copy.

The port's copy of ``ceph_tpu/common/copytrack.py``, on the port's
``perf_counters``.  Every site that materialises a new host buffer
(messenger recv and send, the stores' transaction staging, EC input
assembly, recovery pushes) books the bytes and a copy count into the
``obs.copy`` logger, under the same counter names as ``ceph_tpu``'s.

Sites book against a collection (a daemon's ``PerfCountersCollection``)
or, without one, against the process-global collection.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

from ..analysis.lockdep import make_lock
from .perf_counters import PerfCounters, PerfCountersCollection, \
    collection

# every booking site (the counter names equal ``ceph_tpu``'s)
SITES: Tuple[str, ...] = ("recv", "send", "store_txn", "ec_assembly",
                          "recovery_push")

LOGGER = "obs.copy"

_lock = make_lock("copytrack::ledgers")
# one ledger PerfCounters per collection, created lazily on first
# booking; weak keys so a shut-down daemon's collection can collect
_ledgers: "weakref.WeakKeyDictionary[PerfCountersCollection, PerfCounters]" = \
    weakref.WeakKeyDictionary()


def ledger(coll: Optional[PerfCountersCollection] = None) -> PerfCounters:
    """The ``obs.copy`` counters for ``coll`` (process-global
    collection when None), created and registered on first use."""
    target = coll if coll is not None else collection()
    with _lock:
        pc = _ledgers.get(target)
        if pc is None:
            pc = target.create(LOGGER)
            for _k in ("bytes_copied", "copies"):
                pc.add_u64_counter(_k)
            for _site in SITES:
                for _suffix in ("bytes", "copies"):
                    pc.add_u64_counter(f"{_site}_{_suffix}")
            _ledgers[target] = pc
        return pc


def book_pc(pc: PerfCounters, site: str, nbytes: int,
            copies: int = 1) -> None:
    """Book against an already-resolved ledger — the hot-loop form
    (the messenger reader caches its ledger at construction): four
    integer adds, no lock, no lookup."""
    if nbytes <= 0 and copies <= 0:
        return
    pc.inc("bytes_copied", nbytes)
    pc.inc("copies", copies)
    pc.inc(f"{site}_bytes", nbytes)
    pc.inc(f"{site}_copies", copies)


def book(site: str, nbytes: int, copies: int = 1,
         coll: Optional[PerfCountersCollection] = None) -> None:
    """Record ``copies`` host copies totalling ``nbytes`` at ``site``
    (one of SITES), resolving the ledger for ``coll`` (process-global
    when None)."""
    book_pc(ledger(coll), site, nbytes, copies)
