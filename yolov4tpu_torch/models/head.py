"""Box decoding: raw head grids -> boxes/scores (inference and train-time
decode).

Counterpart of ``yolov4tpu.models.head`` (reference custom_layers.py:221-257):

    box_xy = ((sigmoid(xy)*xyscale) - 0.5*(xyscale-1) + grid) * stride
    box_wh = exp(wh) * anchors            # pixel units

YOLOv4-P6 (Scaled-YOLOv4) decodes the size as ``box_wh = (2 *
sigmoid(wh))**2 * anchors`` (``ops.detect.wh_scaled``) and the centre as
above at xyscale 2; ``ops.detect.WH_DECODES`` maps each
``YoloConfig.arch`` to its size decode, chosen once where a function is
built.

Channel 0 of the grid is the column (x) index, channel 1 the row (y) index.
This decomposed path is what the fused path (``ops.detect``) is tested
against; raw grids are NHWC with channels laid out (anchor, 5+C).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..ops.detect import wh_exp


def _xy_grid(grid_h: int, grid_w: int, device) -> torch.Tensor:
    """(grid_h, grid_w, 1, 2) float grid; [...,0]=col(x), [...,1]=row(y)."""
    rows, cols = torch.meshgrid(
        torch.arange(grid_h, dtype=torch.float32, device=device),
        torch.arange(grid_w, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([cols, rows], dim=-1)[:, :, None, :]


def get_boxes(raw, anchors, num_classes: int, stride: int, xyscale: float,
              wh_decode=wh_exp):
    """Inference decode for one scale.

    raw: (B, g, g, A*(5+C)) raw conv output; anchors: (A, 2) pixels.
    Returns (corners (B,g,g,A,4) absolute pixels, obj (B,g,g,A,1),
    cls (B,g,g,A,C), xywh (B,g,g,A,4) with xy in sigmoid space).
    """
    b, gh, gw = raw.shape[0], raw.shape[1], raw.shape[2]
    p = raw.reshape(b, gh, gw, len(anchors), 5 + num_classes)
    box_xy = torch.sigmoid(p[..., 0:2])
    box_wh = p[..., 2:4]
    obj = torch.sigmoid(p[..., 4:5])
    cls = torch.sigmoid(p[..., 5:])
    pred_xywh = torch.cat([box_xy, box_wh], dim=-1)

    grid = _xy_grid(gh, gw, raw.device)
    xy = ((box_xy * xyscale) - 0.5 * (xyscale - 1.0) + grid) * stride
    wh = wh_decode(box_wh) * torch.as_tensor(anchors, dtype=torch.float32,
                                             device=raw.device)
    corners = torch.cat([xy - wh / 2.0, xy + wh / 2.0], dim=-1)
    return corners, obj, cls, pred_xywh


def decode_head(raw_outputs: Sequence, anchors_grouped, num_classes: int,
                strides: Sequence[int], xyscale: Sequence[float],
                wh_decode=wh_exp):
    """All-scale decode: the flat list of 4 a scale [corners0, obj0, cls0,
    xywh0, corners1, ...] the reference head emits."""
    out: List = []
    for i, raw in enumerate(raw_outputs):
        out.extend(get_boxes(raw, anchors_grouped[i], num_classes,
                             strides[i], xyscale[i], wh_decode))
    return out


def flatten_boxes_scores(head_outputs, img_size: int, num_classes: int):
    """Concat per-scale decodes into NMS inputs: boxes (B, N, 4) normalised
    to [0,1] by img_size, scores (B, N, C) = obj * class."""
    boxes, scores = [], []
    for s in range(0, len(head_outputs), 4):
        corners, obj, cls = head_outputs[s], head_outputs[s + 1], head_outputs[s + 2]
        b = corners.shape[0]
        boxes.append(corners.reshape(b, -1, 4))
        scores.append((obj * cls).reshape(b, -1, num_classes))
    return torch.cat(boxes, dim=1) / float(img_size), torch.cat(scores, dim=1)


def decode_train(raw, anchors, stride: int, num_classes: int):
    """Train-time decode (reference loss.py:191-211): no xyscale.

    raw: (B, g, g, 3*(5+C)).  Returns (B, g, g, 3, 5+C):
    [xywh pixels, sigmoid conf, sigmoid class probs].
    """
    b, gh, gw = raw.shape[0], raw.shape[1], raw.shape[2]
    p = raw.reshape(b, gh, gw, 3, 5 + num_classes)
    grid = _xy_grid(gh, gw, raw.device)
    xy = (torch.sigmoid(p[..., 0:2]) + grid) * stride
    wh = torch.exp(p[..., 2:4]) * torch.as_tensor(anchors, dtype=torch.float32,
                                                  device=raw.device)
    conf = torch.sigmoid(p[..., 4:5])
    prob = torch.sigmoid(p[..., 5:])
    return torch.cat([xy, wh, conf, prob], dim=-1)
