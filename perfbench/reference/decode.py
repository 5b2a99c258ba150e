"""The tf.keras reference's inference decode (custom_layers.py:221-257):
every anchor of the three raw grids as a corner box normalised by the
input side and its per-class scores sigmoid(obj) * sigmoid(class)."""

from __future__ import annotations

import torch

ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
           (142, 110), (192, 243), (459, 401))
STRIDES = (8, 16, 32)
XYSCALE = (1.2, 1.1, 1.05)


def decode(raws, num_classes: int, side: int, anchors=ANCHORS,
           strides=STRIDES, xyscale=XYSCALE):
    """raws: three (B, g, g, 3 * (5 + C)) NHWC grids -> boxes (B, N, 4)
    corners in [0, 1] coordinates (not clipped) and scores (B, N, C),
    anchors in (row, column, anchor) order."""
    boxes, scores = [], []
    for i, raw in enumerate(raws):
        b, gh, gw = raw.shape[:3]
        p = raw.float().reshape(b, gh, gw, 3, 5 + num_classes)
        rows, cols = torch.meshgrid(
            torch.arange(gh, device=raw.device, dtype=torch.float32),
            torch.arange(gw, device=raw.device, dtype=torch.float32),
            indexing="ij")
        grid = torch.stack([cols, rows], -1)[:, :, None, :]
        a = torch.tensor(anchors[3 * i:3 * i + 3], dtype=torch.float32,
                         device=raw.device)
        s = xyscale[i]
        xy = ((torch.sigmoid(p[..., :2]) * s) - 0.5 * (s - 1) + grid) \
            * strides[i]
        wh = torch.exp(p[..., 2:4]) * a
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1)
                     .reshape(b, -1, 4) / side)
        scores.append((torch.sigmoid(p[..., 4:5]) * torch.sigmoid(p[..., 5:]))
                      .reshape(b, -1, num_classes))
    return torch.cat(boxes, 1), torch.cat(scores, 1)
