"""PG log entries — the pg_log_entry_t wire and disk form.

The port's copy of ``ceph_tpu/services/pg_log.py``.  The role of
src/osd/osd_types.h pg_log_entry_t: each write or delete appends one
record to the PG's omap-resident log; peering reads the newest record
of each object (tombstones included) to compute missing sets.

Records travel through the versioned envelope; a bare-dict record
(writer v0) still decodes, with the same field defaults.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..common import encoding
from ..common.encoding import MalformedInput, Versioned


@dataclass
class PgLogEntry(Versioned):
    """One log record: op kind, object, version stamp, and (for
    writes) the shard position and logical size."""

    STRUCT_V = 1
    COMPAT_V = 1

    op: str = "write"        # "write" | "delete"
    oid: str = ""
    v: str = ""              # the version stamp (common.version)
    shard: int = -1          # -1: not a shard-positional record
    size: int = 0

    def to_dict(self) -> dict:
        return {"op": self.op, "oid": self.oid, "v": self.v,
                "shard": self.shard, "size": self.size}

    @classmethod
    def from_dict(cls, d: dict) -> "PgLogEntry":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @property
    def deleted(self) -> bool:
        return self.op == "delete"

    # -- omap value form ----------------------------------------------
    def encode_blob(self) -> bytes:
        return self.encode_versioned().encode()

    @classmethod
    def decode_blob(cls, raw: bytes) -> "PgLogEntry":
        """Lenient: pre-envelope raw-dict records (writer v0) decode
        with the same field defaults."""
        v, d = encoding.decode_any(raw, supported=cls.STRUCT_V,
                                   struct="osd.pg_log_entry")
        if not isinstance(d, dict):
            raise MalformedInput(
                f"osd.pg_log_entry v{v}: payload is not an object")
        try:
            return cls.from_dict(cls.upgrade(max(v, 1), d))
        except (KeyError, TypeError, ValueError) as e:
            raise MalformedInput(
                f"osd.pg_log_entry v{v}: bad payload: {e!r}")
