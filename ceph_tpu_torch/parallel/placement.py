"""Placement statistics over a batch of CRUSH results.

The port of ``ceph_tpu/parallel/placement.py:utilization`` only: the
per-OSD tally of the CrushTester stats pass.  ``ceph_tpu`` runs it as an
XLA scatter-add outside any Pallas kernel; on one card it is one
``torch.bincount``.  The mesh plane (``PlacementPlane``,
``sharded_rule_fn``) is not ported yet.
"""

from __future__ import annotations

import torch


def utilization(results: torch.Tensor, lens: torch.Tensor,
                max_devices: int) -> torch.Tensor:
    """Per-OSD placement counts, int64[max_devices], on the device of
    ``results`` (the CrushTester stats pass,
    src/crush/CrushTester.cc:588-648): entries past each row's length
    and ids outside ``[0, max_devices)`` are not counted."""
    pos = torch.arange(results.shape[-1], device=results.device)
    valid = (pos[None, :] < lens[:, None]) & (results >= 0) \
        & (results < max_devices)
    flat = torch.where(valid, results, max_devices).reshape(-1)
    return torch.bincount(flat, minlength=max_devices + 1)[:max_devices]
