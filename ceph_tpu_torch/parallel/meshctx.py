"""Process-default data-plane mesh holder + batch padding arithmetic.

The port of ``ceph_tpu/parallel/meshctx.py``.  Deliberately
dependency-free (no torch, no crush): the EC engine reads the default
mesh on every ``encode_batched`` call, and plugin-only processes must
not pay the CRUSH mapper's imports for a data plane they never shard.
``parallel.placement`` re-exports everything here under its public
names.
"""

from __future__ import annotations

_mesh = None


def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def get_mesh():
    return _mesh


def pad_batch(n: int, n_dev: int) -> int:
    """The padded batch size for ``n`` items over ``n_dev`` devices:
    next power of two, raised to a multiple of the mesh size.

    The port pads nothing on the card (it has no compile cache to
    bound); it keys the shape signatures its perf counters book by this
    size, as ``ceph_tpu`` does, so a signature table and the
    steady-state gate mean the same in both packages."""
    n = max(1, int(n))
    p = 1 << (n - 1).bit_length()
    if p % n_dev:
        p = ((p + n_dev - 1) // n_dev) * n_dev
    return p
