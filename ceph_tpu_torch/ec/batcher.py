"""EncodeBatcher — cross-thread EC encode coalescing.

The port of ``ceph_tpu/ec/batcher.py``: an OSD primary serving many
concurrent EC writes pays one kernel launch (and its host work) per
object.  Concurrent ``encode`` calls queue here; the first waiter to
take the leader mutex drains the queue, groups requests by (code,
object size, wanted chunks), and runs ONE ``encode_batched`` per group
(byte-identical to per-object encode), completing every waiter.  A lone
caller is its own leader: the depth-1 path is a plain ``encode``.

``ceph_tpu`` pads a batch to a power of two with zero objects to bound
XLA's compile signatures; the port has no compile cache, so it encodes
only the objects it was given.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..analysis.lockdep import make_lock
from .engine import book_batch

MAX_BATCH = 16  # objects per batched dispatch


class _EncodeReq:
    __slots__ = ("code", "want", "raw", "done", "out", "error")

    def __init__(self, code, want, raw):
        self.code = code
        self.want = want
        self.raw = raw
        self.done = threading.Event()
        self.out: Optional[Dict] = None
        self.error: Optional[BaseException] = None


def _size(raw) -> int:
    """An object's length in bytes (bytes-like, array or tensor)."""
    nbytes = getattr(raw, "nbytes", None)
    return int(nbytes) if nbytes is not None else len(raw)


class EncodeBatcher:
    """``mesh``: a mesh (``parallel.placement.Mesh``) threaded through
    to ``ErasureCode.encode_batched``, so a coalesced dispatch splits
    its stripe batch over the mesh's devices; None defers to the
    process default (``parallel.placement.set_data_plane_mesh``)."""

    def __init__(self, max_delay_us: int = 0,
                 max_batch: int = MAX_BATCH, mesh=None):
        self._mutex = make_lock("ec::batch_leader")
        self._qlock = make_lock("ec::batch_q")
        self._q: List[_EncodeReq] = []
        self._delay = max(0, max_delay_us) / 1e6
        self._max_batch = max(1, max_batch)
        self._mesh = mesh

    def encode(self, code, want_to_encode, raw) -> Dict:
        """Drop-in for ``code.encode(want, raw)``: queue, then either
        lead a batched dispatch for everyone queued or wait for a
        concurrent leader to cover this request.  ``raw`` is read in
        place: the caller blocks until its group's dispatch is done."""
        req = _EncodeReq(code, set(want_to_encode), raw)
        with self._qlock:
            self._q.append(req)
        while not req.done.is_set():
            if self._mutex.acquire(timeout=0.05):
                try:
                    if not req.done.is_set():
                        self._drain()
                finally:
                    self._mutex.release()
        if req.error is not None:
            raise req.error
        return req.out

    def _drain(self) -> None:
        if self._delay > 0:
            # widen the batch: let concurrent writers land their
            # requests before the shared dispatch (bounded by the knob);
            # the leader mutex is the coalescing role, not a data lock
            time.sleep(self._delay)
        with self._qlock:
            batch, self._q = self._q, []
        if not batch:
            return
        groups: Dict[Tuple, List[_EncodeReq]] = {}
        for r in batch:
            groups.setdefault(
                (id(r.code), _size(r.raw), tuple(sorted(r.want))),
                []).append(r)
        for reqs in groups.values():
            try:
                self._run_group(reqs)
            except Exception as e:
                for r in reqs:
                    r.error = e
            finally:
                for r in reqs:
                    r.done.set()

    def _run_group(self, reqs: List[_EncodeReq]) -> None:
        code = reqs[0].code
        want = reqs[0].want
        if len(reqs) == 1:
            reqs[0].out = code.encode(want, reqs[0].raw)
            book_batch(1)
            return
        for lo in range(0, len(reqs), self._max_batch):
            part = reqs[lo:lo + self._max_batch]
            outs = code.encode_batched(want, [r.raw for r in part],
                                       mesh=self._mesh)
            for r, out in zip(part, outs):
                r.out = out
            book_batch(len(part))
