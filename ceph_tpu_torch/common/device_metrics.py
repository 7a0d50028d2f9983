"""Device-plane metrics — the accelerator half of the telemetry plane.

The port of ``ceph_tpu/common/device_metrics.py`` on ``torch.cuda``.
The process-global accounting the kernel entry points (``ec.engine``,
``crush.mapper``, ``parallel.placement``) book into:

- ``device`` perf logger: h2d/d2h transfer bytes, kernel launch
  count/time, live-buffer count/bytes gauges with a highwater mark.
- a per-shape-signature table: wall time + transfer volume keyed by
  ``<logger>|<signature>`` (``<logger>|<kind>:<signature>`` where the
  caller names a kind; the text is made when the table is read, not
  on a launch); a new row in steady state is a cache
  rebuild (``analysis.contracts.steady_state`` watches the same
  signatures through the loggers' ``jit_compiles``).  Bounded.
- a per-mesh-device table: one row per mesh position (a mesh may name
  one card more than once), the launches, time and transfer share each
  shard booked.

Times are the host's clock around an asynchronous launch: the enqueue
time, not the kernel's (as ``ceph_tpu`` books around an asynchronous
dispatch).  Nothing here synchronizes a device.

``sample_memory()`` never creates a CUDA context: it reads
``torch.cuda`` only when the process has already initialised it, so a
process that never touches the card pays nothing.  ``per_device()``
initialises the card on purpose.
"""

from __future__ import annotations

import sys
from typing import Dict, List

from ..analysis.lockdep import make_lock
from .perf_counters import collection

_pc = collection().create("device")
for _k in ("h2d_bytes", "d2h_bytes", "kernel_launches"):
    _pc.add_u64_counter(_k)
_pc.add_time("kernel_time")
for _k in ("live_buffers", "live_buffer_bytes",
           "live_buffer_bytes_hw"):
    _pc.add_u64(_k)

# the port's caches that a steady state must not rebuild (its twin of
# an XLA recompile): K2's launch plans, maps lowered to a device, and
# bit matrices put on a device with their kernel's form (decode
# inverses, a mesh device's copy of a coding matrix).  Not in
# ``ceph_tpu``, which has no such caches; its own logger, so the
# loggers both packages share dump the same keys.
_caches = collection().create("device.caches")
CACHES = ("launch_plans", "lowered_maps", "matrices")
for _k in CACHES:
    _caches.add_u64_counter(_k)


def note_rebuild(cache: str) -> None:
    """Count one build of a ``CACHES`` entry."""
    _caches.inc(cache)


# (logger, kind, signature) -> aggregate launch stats; bounded so a
# shape leak degrades to a truncated table, never unbounded memory
_MAX_SHAPES = 256
_shapes: Dict[tuple, Dict[str, float]] = {}
_shapes_lock = make_lock("device::shapes")
_buffer_hw = 0

# mesh position -> aggregate mesh-launch stats: each participating
# shard books the call's wall time and its 1/N share of the transfer
# volume, so ``mesh_device_report`` shows work on every mesh position
_mesh_devices: Dict[int, Dict[str, float]] = {}


def _shape_key(key: tuple) -> str:
    logger, kind, sig = key
    return f"{logger}|{kind}:{sig}" if kind else f"{logger}|{sig}"


def record_launch(logger: str, sig: object, seconds: float,
                  h2d_bytes: int = 0, d2h_bytes: int = 0,
                  kind: str = "") -> None:
    """Book one kernel launch: the bytes the caller moved host->device
    (inputs) and device->host (outputs) beside the host time.  ``sig``
    is hashable; it is formatted only when the table is read."""
    _pc.update((("kernel_launches", 1), ("kernel_time", seconds),
                ("h2d_bytes", h2d_bytes), ("d2h_bytes", d2h_bytes)))
    key = (logger, kind, sig)
    with _shapes_lock:
        rec = _shapes.get(key)
        if rec is None:
            if len(_shapes) >= _MAX_SHAPES:
                return
            rec = _shapes[key] = {"count": 0, "time_s": 0.0,
                                  "h2d_bytes": 0, "d2h_bytes": 0}
        rec["count"] += 1
        rec["time_s"] += seconds
        rec["h2d_bytes"] += h2d_bytes
        rec["d2h_bytes"] += d2h_bytes


def record_mesh_launch(logger: str, sig: object, seconds: float,
                       device_ids, h2d_bytes: int = 0,
                       d2h_bytes: int = 0, kind: str = "") -> None:
    """Book one call over a mesh: ``record_launch``'s aggregate plus a
    row for every mesh position in ``device_ids``."""
    ids = [int(i) for i in device_ids]
    record_launch(logger, sig, seconds,
                  h2d_bytes=h2d_bytes, d2h_bytes=d2h_bytes, kind=kind)
    n = max(1, len(ids))
    with _shapes_lock:
        for did in ids:
            rec = _mesh_devices.get(did)
            if rec is None:
                rec = _mesh_devices[did] = {
                    "launches": 0, "kernel_time_s": 0.0,
                    "h2d_bytes": 0, "d2h_bytes": 0}
            rec["launches"] += 1
            rec["kernel_time_s"] += seconds
            rec["h2d_bytes"] += h2d_bytes // n
            rec["d2h_bytes"] += d2h_bytes // n


def mesh_device_table() -> Dict[int, Dict[str, float]]:
    """Per-mesh-position aggregates (copied)."""
    with _shapes_lock:
        return {k: dict(v) for k, v in _mesh_devices.items()}


def shape_table() -> Dict[str, Dict[str, float]]:
    """Per-shape-signature launch aggregates (copied), keyed by
    ``<logger>|[<kind>:]<signature>``."""
    with _shapes_lock:
        return {_shape_key(k): dict(v) for k, v in _shapes.items()}


def _cuda():
    """``torch.cuda`` when torch is imported and the process has
    initialised CUDA already, else None: a sampler must never create a
    context."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda


def sample_memory() -> None:
    """Refresh the live-buffer gauges and their highwater from the
    caching allocator of every card (``active.all.current`` blocks,
    ``memory_allocated`` bytes).  A no-op unless CUDA is initialised."""
    global _buffer_hw
    cuda = _cuda()
    if cuda is None:
        return
    total = n = 0
    for i in range(cuda.device_count()):
        stats = cuda.memory_stats(i)
        n += int(stats.get("active.all.current", 0))
        total += int(cuda.memory_allocated(i))
    _pc.set("live_buffers", n)
    _pc.set("live_buffer_bytes", total)
    if total > _buffer_hw:
        _buffer_hw = total
    _pc.set("live_buffer_bytes_hw", _buffer_hw)


def per_device() -> List[Dict]:
    """One row per CUDA device: id, platform, name and the allocator's
    ``bytes_in_use`` / ``peak_bytes_in_use``.  Initialises CUDA: call
    it only from code that owns device work, never from a sampler.
    Empty without a card."""
    import torch

    out: List[Dict] = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "id": i, "platform": "cuda",
            "name": torch.cuda.get_device_name(i),
            "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))})
    return out


def reset_for_tests() -> None:
    global _buffer_hw
    with _shapes_lock:
        _shapes.clear()
        _mesh_devices.clear()
    _buffer_hw = 0
