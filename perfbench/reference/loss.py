"""The tf.keras reference's YOLOv4 loss (loss.py:116-211) in plain
PyTorch: per scale, the training decode (no xyscale), a GIoU box term
scaled by 2 - wh / side^2, a sigmoid cross-entropy class term, and a
focal-weighted confidence term whose background cells are those whose best
IoU with any true box is under ``iou_loss_thresh``; each term summed per
image and averaged over the batch, weighted 3.54, 64.3 and 1."""

from __future__ import annotations

import torch

from .decode import ANCHORS, STRIDES

EPS = 1e-7  # tf.keras.backend.epsilon()
WEIGHTS = (3.54, 64.3, 1.0)


def _corners(b):
    return torch.cat([b[..., :2] - b[..., 2:] * 0.5,
                      b[..., :2] + b[..., 2:] * 0.5], -1)


def _inter_union(a, b):
    ca, cb = _corners(a), _corners(b)
    wh = torch.clamp(torch.minimum(ca[..., 2:], cb[..., 2:])
                     - torch.maximum(ca[..., :2], cb[..., :2]), min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter, ca, cb


def iou(a, b):
    inter, union, _, _ = _inter_union(a, b)
    return inter / (union + EPS)


def giou(a, b):
    inter, union, ca, cb = _inter_union(a, b)
    ewh = (torch.maximum(ca[..., 2:], cb[..., 2:])
           - torch.minimum(ca[..., :2], cb[..., :2]))
    enclose = ewh[..., 0] * ewh[..., 1]
    nz = enclose != 0
    return inter / (union + EPS) - torch.where(
        nz, (enclose - union) / torch.where(nz, enclose, 1.0), 0.0)


def sigmoid_ce(z, x):
    return torch.clamp(x, min=0) - x * z + torch.log1p(torch.exp(-x.abs()))


def scale_terms(raw, label, true_boxes, stride, anchors, num_classes,
                iou_loss_thresh):
    b, g = raw.shape[0], raw.shape[1]
    side = float(stride * g)
    p = raw.float().reshape(b, g, g, 3, 5 + num_classes)
    rows, cols = torch.meshgrid(
        torch.arange(g, device=raw.device, dtype=torch.float32),
        torch.arange(g, device=raw.device, dtype=torch.float32),
        indexing="ij")
    grid = torch.stack([cols, rows], -1)[:, :, None, :]
    a = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    pred_xywh = torch.cat([(torch.sigmoid(p[..., :2]) + grid) * stride,
                           torch.exp(p[..., 2:4]) * a], -1)
    pred_conf = torch.sigmoid(p[..., 4:5])
    respond = label[..., 4:5]
    box = respond * (2.0 - label[..., 2:3] * label[..., 3:4] / side ** 2) \
        * (1.0 - giou(pred_xywh, label[..., :4])[..., None])
    prob = respond * sigmoid_ce(label[..., 5:], p[..., 5:])
    with torch.no_grad():
        best = iou(pred_xywh[:, :, :, :, None, :],
                   true_boxes[:, None, None, None, :, :]).amax(-1)[..., None]
    background = (1.0 - respond) * (best < iou_loss_thresh).float()
    ce = sigmoid_ce(respond, p[..., 4:5])
    conf = (respond - pred_conf) ** 2 * (respond * ce + background * ce)
    return [t.sum(dim=(1, 2, 3, 4)).mean() for t in (box, conf, prob)]


def yolo_loss(raws, labels, true_boxes, num_classes: int,
              iou_loss_thresh: float = 0.5, anchors=ANCHORS,
              strides=STRIDES):
    """Total loss of the three raw grids against the encoded labels."""
    total = 0.0
    for i, (raw, label) in enumerate(zip(raws, labels)):
        terms = scale_terms(raw, label, true_boxes, strides[i],
                            anchors[3 * i:3 * i + 3], num_classes,
                            iou_loss_thresh)
        total = total + sum(w * t for w, t in zip(WEIGHTS, terms))
    return total
