"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the card.  Without one this raises instead of running
    on the CPU: the CPU (the kernels' plain versions) is used only when
    the caller asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def canonical_device(device) -> torch.device:
    """``device`` as a tensor on it reports it: a card with its index
    (the current one when none is given), the CPU without one (tensors
    on ``cpu:1`` live on ``cpu``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def gather(parts, device) -> torch.Tensor:
    """Shards' outputs joined along their first axis on ``device``; one
    part is returned as it is (no copy)."""
    if len(parts) == 1:
        return parts[0]
    with device_guard(device):
        return torch.cat([p.to(device, non_blocking=True) for p in parts])


def device_guard(device):
    """A context that makes a card the current device for the launches
    inside it (nothing for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()
