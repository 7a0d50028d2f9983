"""Object versions — the eversion_t (epoch, version) role.

The port's copy of ``ceph_tpu/common/version.py``.

One definition shared by writers (client), storers (osd_service), and
peering: zero-padded decimal fields so STRING comparison is version
comparison.  Any change here must change every comparer at once —
that's why there is exactly one copy.
"""

from __future__ import annotations

import time


def make_version(epoch: int) -> str:
    """Totally-ordered object version: map epoch + wall timestamp.
    All shards of one logical write share one version, so replicas
    agree on recency at peering time."""
    return f"{epoch:012d}.{time.time_ns():020d}"


NULL_VERSION = "0" * 12 + "." + "0" * 20


def bump(version: str) -> str:
    """The smallest version strictly greater than ``version`` (same
    epoch field, timestamp+1).  Lets a writer whose wall clock lags a
    stored version re-stamp PAST it instead of silently losing
    last-writer-wins — the read-your-writes repair for client clock
    skew."""
    epoch_s, ts_s = version.split(".")
    return f"{epoch_s}.{int(ts_s) + 1:020d}"
