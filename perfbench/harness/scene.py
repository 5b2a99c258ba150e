"""Seeded test rasters: smooth 16-pixel blocks plus Gaussian noise, uint8
RGB (a copy of the smoke script's ``scene``), made on the device in one
call and handed over on the host, where users' images are."""

from __future__ import annotations

import torch


def scene(seed: int, count: int, height: int, width: int, device):
    """(count, height, width, 3) uint8 numpy array."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    coarse = torch.rand((count, -(-height // 16), -(-width // 16), 3),
                        generator=g, device=device) * 255
    smooth = coarse.repeat_interleave(16, 1).repeat_interleave(16, 2)
    smooth = smooth[:, :height, :width]
    noise = torch.randn(smooth.shape, generator=g, device=device) * 25
    return (smooth + noise).clamp(0, 255).to(torch.uint8).cpu().numpy()
