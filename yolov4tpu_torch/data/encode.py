"""Ground-truth label encoding: boxes -> per-scale anchor grids.

Counterpart of ``yolov4tpu.data.encode``: the port's own copy of the host
encoder (vectorised numpy, the reference's loop semantics) and
``encode_labels_torch``, the device encoder that is bit-identical to it
(the counterpart of ``encode_labels_jax``).

Semantics (reference utils.py:210-303):
  - box centers use integer floor-division by 2 (``(x1+x2)//2``);
  - grids store ABSOLUTE pixel xy/wh, conf 1, one-hot class;
  - anchor assignment: IoU of each GT wh against all 9 anchors centred at the
    origin, argmax wins, the anchor's scale via mask [[0,1,2],[3,4,5],[6,7,8]];
  - collisions: a later box overwrites an earlier one's xy/wh/conf in the
    same (cell, anchor), but one-hot class flags accumulate;
  - out-of-range grid indices (a box centred on the image edge) are clipped.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

ANCHOR_MASK = ((0, 1, 2), (3, 4, 5), (6, 7, 8))


def _grid_index_table(extent: int, g: int) -> np.ndarray:
    """Host-semantics cell index for every integral center 0..extent.

    The host computes ``floor(f32(v / extent) * g)`` with numpy's promotion
    (f32/int -> f64 divide, cast to f32, f32*int -> f64 multiply); other
    orders of the same arithmetic round differently exactly when a center
    sits on a cell boundary (264/416*52: host 32.99999.., not 33).  Centers
    are integral, so a table built with the host's own ops makes the device
    encoder bit-identical by construction.
    """
    v = np.arange(extent + 1, dtype=np.float32)
    norm = (v / np.int32(extent)).astype(np.float32)
    idx = np.floor(norm * np.int32(g))
    return np.clip(idx, 0, g - 1).astype(np.int32)


def best_anchor_ious(wh: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """IoU of GT wh (..., 2) vs anchors (9, 2), both centred at origin -> (..., 9)."""
    wh_e = wh[..., None, :]
    inter = np.minimum(wh_e / 2.0, anchors / 2.0) - np.maximum(-wh_e / 2.0, -anchors / 2.0)
    inter = np.maximum(inter, 0.0)
    inter_area = inter[..., 0] * inter[..., 1]
    box_area = wh_e[..., 0] * wh_e[..., 1]
    anchor_area = anchors[:, 0] * anchors[:, 1]
    return inter_area / (box_area + anchor_area - inter_area)


def preprocess_true_boxes(
    true_boxes, input_shape, anchors, num_classes: int,
    strides: Sequence[int] = (8, 16, 32),
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Encode corner boxes into YOLO training grids (host, numpy).

    true_boxes: (bs, max_boxes, 5) absolute [x1, y1, x2, y2, class_id];
        zero rows = padding.
    input_shape: (h, w).
    anchors: (9, 2) pixel wh.
    Returns (y_true list of (bs, g, g, 3, 5+C) float32 grids,
             y_true_boxes_xywh (bs, max_boxes, 4) absolute center-format).
    """
    true_boxes = np.asarray(true_boxes, dtype=np.float32)
    input_shape = np.asarray(input_shape, dtype=np.int32)
    anchors = np.asarray(anchors, dtype=np.float32)
    bs, max_boxes = true_boxes.shape[:2]

    xy = (true_boxes[..., 0:2] + true_boxes[..., 2:4]) // 2  # floor: parity
    wh = true_boxes[..., 2:4] - true_boxes[..., 0:2]
    # Normalised by (w, h) — input_shape is (h, w), reversed as the
    # reference does — and stored as float32 like the reference's array.
    norm_xy = (xy / input_shape[::-1]).astype(np.float32)

    grid_sizes = [input_shape // s for s in strides]
    y_true = [
        np.zeros((bs, g[0], g[1], 3, 5 + num_classes), dtype=np.float32)
        for g in grid_sizes
    ]
    y_true_boxes_xywh = np.concatenate([xy, wh], axis=-1)

    valid = wh[..., 0] > 0
    if not valid.any():
        return y_true, y_true_boxes_xywh

    iou = best_anchor_ious(np.where(valid[..., None], wh, 1.0), anchors)
    best_anchor = iou.argmax(axis=-1)  # (bs, max_boxes)

    for stage in range(len(strides)):
        sel = valid & (best_anchor // 3 == stage)
        if not sel.any():
            continue
        # Row-major order (batch, then box): duplicate-cell writes resolve as
        # the reference's loops do (last box wins).
        b_idx, box_idx = np.nonzero(sel)
        g = grid_sizes[stage]
        col = np.floor(norm_xy[b_idx, box_idx, 0] * g[1]).astype(np.int64)
        row = np.floor(norm_xy[b_idx, box_idx, 1] * g[0]).astype(np.int64)
        col = np.clip(col, 0, g[1] - 1)
        row = np.clip(row, 0, g[0] - 1)
        a_idx = best_anchor[b_idx, box_idx] % 3
        cls = true_boxes[b_idx, box_idx, 4].astype(np.int64)

        y = y_true[stage]
        y[b_idx, row, col, a_idx, 0:2] = xy[b_idx, box_idx]
        y[b_idx, row, col, a_idx, 2:4] = wh[b_idx, box_idx]
        y[b_idx, row, col, a_idx, 4] = 1.0
        y[b_idx, row, col, a_idx, 5 + cls] = 1.0

    return y_true, y_true_boxes_xywh


def encode_labels_torch(true_boxes, input_shape: Tuple[int, int], anchors,
                        num_classes: int, strides: Sequence[int] = (8, 16, 32)):
    """Device label encoder, same contract as ``preprocess_true_boxes``, on
    a (bs, max_boxes, 5) float32 tensor (on any device) -> (list of
    (bs, g, g, 3, 5+C) grids, (bs, max_boxes, 4) xywh), tensors on its
    device.

    Collisions are deterministic and bit-identical to the host encoder:
    when several boxes map to one (cell, anchor), the last box wins the
    xy/wh/conf row and the class flags of all of them accumulate.  A
    pre-scatter dedup (a box shadowed by a later box in the same cell does
    not write) leaves no duplicate index with conflicting rows, so the row
    scatter does not depend on the order the device applies it in (a
    scatter with duplicate indices does); the class flags are a scatter-max,
    which is order-independent.  Rows of unselected and shadowed boxes go to
    a spare row past the grid that is cut off afterwards.
    """
    true_boxes = torch.as_tensor(true_boxes, dtype=torch.float32)
    dev = true_boxes.device
    h, w = int(input_shape[0]), int(input_shape[1])
    anchors_t = torch.as_tensor(np.asarray(anchors, np.float32), device=dev)
    bs, max_boxes = true_boxes.shape[:2]

    xy = torch.div(true_boxes[..., 0:2] + true_boxes[..., 2:4], 2.0,
                   rounding_mode="floor")
    wh = true_boxes[..., 2:4] - true_boxes[..., 0:2]
    valid = wh[..., 0] > 0

    wh_e = torch.where(valid[..., None], wh, 1.0)[..., None, :]
    inter = (torch.minimum(wh_e / 2, anchors_t / 2)
             - torch.maximum(-wh_e / 2, -anchors_t / 2))
    inter = torch.clamp(inter, min=0.0)
    inter_area = inter[..., 0] * inter[..., 1]
    iou = inter_area / (wh_e[..., 0] * wh_e[..., 1]
                        + anchors_t[:, 0] * anchors_t[:, 1] - inter_area)
    best_anchor = torch.argmax(iou, dim=-1)      # first max, as numpy's

    cls = true_boxes[..., 4].to(torch.int64)
    # Out-of-range class ids give an all-zero row, as jax.nn.one_hot does.
    one_hot = (cls[..., None] == torch.arange(num_classes, device=dev)
               ).to(torch.float32)
    row_vec = torch.cat([xy, wh, torch.ones_like(xy[..., :1]), one_hot],
                        dim=-1)                  # (bs, mb, 5+C)
    box_i = torch.arange(max_boxes, device=dev)
    later = box_i[None, :] > box_i[:, None]      # (mb, mb)
    xi = torch.clamp(xy[..., 0], 0, w).to(torch.int64)
    yi = torch.clamp(xy[..., 1], 0, h).to(torch.int64)
    y_true = []
    for stage, s in enumerate(strides):
        gh, gw = h // s, w // s
        sel = valid & (best_anchor // 3 == stage)
        col = torch.as_tensor(_grid_index_table(w, gw), device=dev)[xi]
        row = torch.as_tensor(_grid_index_table(h, gh), device=dev)[yi]
        a_idx = best_anchor % 3
        n_cell = gh * gw * 3
        flat = (row.to(torch.int64) * gw + col) * 3 + a_idx
        flat = torch.where(sel, flat, n_cell)
        # Unselected boxes sit at n_cell (above any cell), so they never
        # shadow a selected one.
        shadowed = (later & (flat[:, :, None] == flat[:, None, :])).any(-1)
        flat_row = torch.where(shadowed, n_cell, flat)
        width = 5 + num_classes
        y = torch.zeros((bs, n_cell + 1, width), dtype=torch.float32,
                        device=dev)
        y.scatter_(1, flat_row[..., None].expand(bs, max_boxes, width),
                   row_vec)
        acc = torch.zeros((bs, n_cell + 1, num_classes), dtype=torch.float32,
                          device=dev)
        acc.scatter_reduce_(1, flat[..., None].expand(bs, max_boxes,
                                                      num_classes),
                            one_hot, reduce="amax")
        y = torch.cat([y[:, :n_cell, :5],
                       torch.maximum(y[:, :n_cell, 5:], acc[:, :n_cell])],
                      dim=-1)
        y_true.append(y.reshape(bs, gh, gw, 3, width))
    return y_true, torch.cat([xy, wh], dim=-1)
