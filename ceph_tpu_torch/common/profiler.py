"""In-process wallclock sampling profiler — folded stacks per role
(the port's copy of ``ceph_tpu/common/profiler.py``).

The reference ships a wallclock profiler that attaches to a live
daemon and emits collapsed stacks; here the daemons are threads in
one process, so the profiler samples ``sys._current_frames()`` from a
dedicated thread instead of ptrace.  Each sample walks every thread's
current stack and accumulates a folded-stack count keyed by *thread
role* — the pool prefix of the thread name (``msgr-dispatch:osd.1_3``
-> ``msgr-dispatch``, ``mclock-w0`` -> ``mclock-w``) — so the output
answers "which role burns wallclock where" without per-thread noise.

Operational shape: the profiler is OFF by default and only ever
started from an admin-socket command (``profile start|stop|dump`` on
every daemon, wired in ``Context``) or from an explicit bench hook.
Sampling uses a
*seeded* jittered interval (mean 1/hz, uniform in [0.5, 1.5]/hz) so
periodic work cannot hide between ticks yet runs stay reproducible,
and retention is bounded: at most ``max_stacks`` distinct folded
stacks (overflow lands in an explicit bucket) and ``max_seconds`` of
sampling before auto-stop, so a forgotten ``profile start`` cannot
grow without bound.

Dump format is flamegraph-collapsed text: ``role;frame;frame count``
per line, which merges across daemons by summing counts.
"""

from __future__ import annotations

import os
import random
import re
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis.lockdep import make_lock

_ROLE_TRIM = re.compile(r"[-_]?\d+$")

# frame-label cache keyed by code object id — stable for the process
# lifetime and saves the basename/format work on every sample
_label_cache: Dict[int, str] = {}


def thread_role(name: str) -> str:
    """Pool role for a thread name: the prefix before the first
    ``:`` with any trailing worker index trimmed."""
    base = (name or "?").split(":", 1)[0]
    return _ROLE_TRIM.sub("", base) or base


def _frame_label(code) -> str:
    label = _label_cache.get(id(code))
    if label is None:
        label = f"{os.path.basename(code.co_filename)}:{code.co_name}"
        _label_cache[id(code)] = label
    return label


def _fold(frame, max_depth: int = 64) -> Tuple[str, ...]:
    """Root-first tuple of frame labels for one thread's stack."""
    rev: List[str] = []
    while frame is not None and len(rev) < max_depth:
        rev.append(_frame_label(frame.f_code))
        frame = frame.f_back
    rev.reverse()
    return tuple(rev)


class WallclockProfiler:
    """One sampler per daemon Context.  Thread-safe; start/stop are
    idempotent; ``profile_start`` runs only when asked for."""

    def __init__(self, hz: float = 100.0, max_seconds: float = 30.0,
                 max_stacks: int = 4096, seed: int = 0,
                 name: str = "prof"):
        self.hz = float(hz)
        self.max_seconds = float(max_seconds)
        self.max_stacks = int(max_stacks)
        self.name = name
        self._rng = random.Random(seed)
        self._lock = make_lock(f"profiler::{name}")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # (role, folded stack) -> sample count
        self._stacks: Dict[Tuple[str, Tuple[str, ...]], int] = {}
        # sampling memos: thread ident -> role (refreshed whenever an
        # unknown ident shows up), and ident -> [frame id, code id,
        # f_lasti, folded key, pending count] so a thread parked in a
        # wait() — the common case in a daemon pool — is not
        # re-folded every tick.  Hits only bump the pending count;
        # counts merge into _stacks on miss/dump, keeping the big
        # (role, stack)-tuple hashing off the per-tick hot path.
        self._roles: Dict[int, str] = {}
        self._memo: Dict[int, List] = {}
        self._samples = 0
        self._truncated = 0
        self._started_at = 0.0
        self._elapsed = 0.0
        # wallclock the sampler itself burned inside _sample — the
        # direct overhead meter (in a GIL-bound process the sampler's
        # GIL-holding share IS the throughput tax on the workload)
        self._self_s = 0.0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def profile_start(self, hz: Optional[float] = None) -> bool:
        """Begin sampling (resets prior retention).  Returns False if
        already running."""
        with self._lock:
            if self.running:
                return False
            if hz:
                self.hz = float(hz)
            self._stacks.clear()
            self._roles.clear()
            self._memo.clear()
            self._samples = 0
            self._truncated = 0
            self._elapsed = 0.0
            self._self_s = 0.0
            self._stop.clear()
            self._started_at = time.monotonic()
            self._thread = threading.Thread(
                target=self._run, name=f"wallclock-prof:{self.name}",
                daemon=True)
            self._thread.start()
            return True

    def profile_stop(self) -> bool:
        """Stop sampling; retained stacks stay dumpable."""
        t = self._thread
        if t is None:
            return False
        self._stop.set()
        t.join(timeout=2.0)
        with self._lock:
            self._thread = None
        return True

    def _run(self) -> None:
        own = threading.get_ident()
        deadline = self._started_at + self.max_seconds
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= deadline:
                break
            # thread_time, not perf_counter: CPU seconds this thread
            # actually burned.  Wallclock would also book intervals
            # where the sampler sat descheduled mid-_sample waiting
            # for the GIL — time the workload was running, not time
            # stolen from it.
            t0 = time.thread_time()
            self._sample(own)
            self._self_s += time.thread_time() - t0
            # seeded jitter: mean 1/hz, never synchronized with
            # periodic daemon work
            interval = (1.0 / max(self.hz, 1e-3)) * \
                (0.5 + self._rng.random())
            self._stop.wait(interval)
        with self._lock:
            self._elapsed = time.monotonic() - self._started_at

    def _sample(self, own_ident: int) -> None:
        frames = sys._current_frames()
        roles = self._roles
        if any(i not in roles for i in frames):
            # a thread we have not seen: rebuild the ident -> role
            # map (threading.enumerate + regex trim per thread is
            # ~30% of raw sample cost — pay it only on churn)
            self._roles = roles = {
                t.ident: thread_role(t.name)
                for t in threading.enumerate()}
        memo = self._memo
        with self._lock:
            self._samples += 1
            for ident, frame in frames.items():
                if ident == own_ident:
                    continue
                # a parked thread (blocked in a pool's wait()) keeps
                # the same top frame at the same instruction between
                # ticks — bump its pending count instead of
                # re-walking the stack.  id() reuse is disarmed by
                # also pinning the code object id and f_lasti; a
                # sampling profiler tolerates the residual
                # (astronomically rare) collision.
                hit = memo.get(ident)
                if hit is not None and hit[0] == id(frame) \
                        and hit[1] == id(frame.f_code) \
                        and hit[2] == frame.f_lasti:
                    hit[4] += 1
                    continue
                if hit is not None:
                    self._merge(hit)
                memo[ident] = [id(frame), id(frame.f_code),
                               frame.f_lasti,
                               (roles.get(ident, "?"), _fold(frame)),
                               1]

    def _merge(self, hit: List) -> None:
        """Fold one memo entry's pending count into the retained
        stacks (lock held), honoring the max_stacks bound."""
        n = hit[4]
        if n <= 0:
            return
        key = hit[3]
        if key not in self._stacks and \
                len(self._stacks) >= self.max_stacks:
            self._truncated += n
            key = (key[0], ("<overflow>",))
        self._stacks[key] = self._stacks.get(key, 0) + n
        hit[4] = 0

    def profile_dump(self) -> Dict:
        """{"running", "hz", "samples", "elapsed", "self_s",
        "truncated", "folded": ["role;frame;... count", ...]} —
        folded lines in flamegraph-collapsed format, highest count
        first; ``self_s`` is the wallclock the sampler itself spent
        walking stacks (the direct overhead meter)."""
        with self._lock:
            for hit in self._memo.values():
                self._merge(hit)
            elapsed = (time.monotonic() - self._started_at
                       if self.running else self._elapsed)
            folded = sorted(self._stacks.items(),
                            key=lambda kv: -kv[1])
            lines = [";".join((role,) + stack) + f" {count}"
                     for (role, stack), count in folded]
            return {
                "running": self.running,
                "hz": self.hz,
                "samples": self._samples,
                "elapsed": round(elapsed, 3),
                "self_s": round(self._self_s, 6),
                "truncated": self._truncated,
                "folded": lines,
            }


def merge_folded(dumps: Dict[str, Dict]) -> Dict[str, int]:
    """Merge per-daemon ``profile_dump`` outputs into one cluster
    folded-stack map (``daemon/role;frames`` -> count) for the
    telemetry flame report."""
    merged: Dict[str, int] = {}
    for daemon, dump in sorted(dumps.items()):
        for line in dump.get("folded", []):
            stack, _, count = line.rpartition(" ")
            try:
                n = int(count)
            except ValueError:
                continue
            key = f"{daemon}/{stack}"
            merged[key] = merged.get(key, 0) + n
    return merged


def render_flame(merged: Dict[str, int], width: int = 60,
                 top: int = 40) -> str:
    """Text flamegraph summary: top folded stacks by sample count
    with a proportional bar — the terminal stand-in for a flamegraph
    SVG (the folded lines themselves feed flamegraph.pl unchanged)."""
    total = sum(merged.values()) or 1
    lines = [f"cluster wallclock profile — {total} samples, "
             f"{len(merged)} distinct stacks (top {top})"]
    ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:top]
    for stack, count in ranked:
        share = count / total
        bar = "#" * max(1, int(share * width))
        leaf = stack.rsplit(";", 1)[-1]
        lines.append(f"{share:>6.1%} {count:>7d} {bar:<{width//3}} "
                     f"{leaf}  [{stack}]")
    return "\n".join(lines)
