"""Ground-truth encoding of the tf.keras reference (utils.py:210-303), one
box at a time in NumPy: each box goes to the anchor of the nine whose
origin-centred rectangle it overlaps best, at that anchor's scale; its
cell row stores the box centre and size in pixels, confidence 1 and its
class flag.  A later box of the same cell and anchor overwrites the
earlier one's box and confidence, and the class flags accumulate.  The
centre is floor((x1 + x2) / 2); the cell is floor(f32(centre / side) *
grid) with the divide in float64 rounded to float32, as the reference
stores it, and the product in float64."""

from __future__ import annotations

import numpy as np

from .decode import ANCHORS, STRIDES


def encode(boxes, side: int, num_classes: int, anchors=ANCHORS,
           strides=STRIDES):
    """boxes (B, M, 5) float32 corners in pixels and class, zero rows for
    padding -> (three (B, g, g, 3, 5 + C) grids, (B, M, 4) centre boxes)."""
    boxes = np.asarray(boxes, np.float32)
    anchors = np.asarray(anchors, np.float32)
    b, m = boxes.shape[:2]
    grids = [np.zeros((b, side // s, side // s, 3, 5 + num_classes),
                      np.float32) for s in strides]
    xywh = np.zeros((b, m, 4), np.float32)
    half = np.float32(0.5)
    for i in range(b):
        for j in range(m):
            x1, y1, x2, y2, c = boxes[i, j]
            cx, cy = np.floor((x1 + x2) * half), np.floor((y1 + y2) * half)
            w, h = x2 - x1, y2 - y1
            xywh[i, j] = (cx, cy, w, h)
            if not w > 0:
                continue
            iw = np.maximum(np.float32(0), np.minimum(w * half, anchors[:, 0]
                                                      * half)
                            - np.maximum(-w * half, -anchors[:, 0] * half))
            ih = np.maximum(np.float32(0), np.minimum(h * half, anchors[:, 1]
                                                      * half)
                            - np.maximum(-h * half, -anchors[:, 1] * half))
            inter = iw * ih
            a = int(np.argmax(inter / (w * h + anchors[:, 0] * anchors[:, 1]
                                       - inter)))
            stage, g = a // 3, side // strides[a // 3]
            col = int(np.floor(np.float64(np.float32(np.float64(cx) / side))
                               * g))
            row = int(np.floor(np.float64(np.float32(np.float64(cy) / side))
                               * g))
            col, row = min(max(col, 0), g - 1), min(max(row, 0), g - 1)
            cell = grids[stage][i, row, col, a % 3]
            cell[:5] = (cx, cy, w, h, 1.0)
            if 0 <= int(c) < num_classes:
                cell[5 + int(c)] = 1.0
    return grids, xywh
