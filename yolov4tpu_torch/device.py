"""Where the port's entry points run: the card unless the caller asks for
the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a host without it
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host; pass "
                           "device='cpu' to run on the CPU")
    return device


def to_device_async(x, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``: for the card, a copy from
    pinned host memory that does not block the caller.  Producer threads
    use it so that batch N+1's copy overlaps batch N's work; the copy runs
    on the current stream, so work queued after it sees the copied bytes."""
    t = torch.as_tensor(x)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)
