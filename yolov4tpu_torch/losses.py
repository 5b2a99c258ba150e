"""YOLOv4 training loss — IoU family + per-scale loss + aggregator.

Counterpart of ``yolov4tpu.losses`` (reference loss.py), the same math:
  - the box term uses GIoU (the reference's CIoU call is commented out,
    reference loss.py:156-157); CIoU is selectable;
  - fixed term weights 3.54 / 64.3 / 1 (reference loss.py:131-133);
  - train-time decode has no xyscale (``models.head.decode_train``);
  - IoU/GIoU denominators use Keras epsilon 1e-7 (reference loss.py:31,50),
    CIoU uses 1e-9 (loss.py:93,107-108);
  - per-term reduction: mean over the batch of per-image sums
    (reference loss.py:184-186), over the valid samples when a mask is given.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .models.head import decode_train

_EPS = 1e-7  # tf.keras.backend.epsilon()


def xywh_to_x1y1x2y2(boxes):
    """Center-format -> corner-format (reference loss.py:10-11)."""
    return torch.cat([boxes[..., :2] - boxes[..., 2:] * 0.5,
                      boxes[..., :2] + boxes[..., 2:] * 0.5], dim=-1)


def _overlap(boxes1, boxes2):
    """(intersection, union) of center-format boxes."""
    area1 = boxes1[..., 2] * boxes1[..., 3]
    area2 = boxes2[..., 2] * boxes2[..., 3]
    b1 = xywh_to_x1y1x2y2(boxes1)
    b2 = xywh_to_x1y1x2y2(boxes2)
    tl = torch.maximum(b1[..., :2], b2[..., :2])
    br = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter, area1 + area2 - inter, b1, b2


def bbox_iou(boxes1, boxes2):
    """Elementwise IoU on center-format boxes (reference loss.py:15-31)."""
    inter, union, _, _ = _overlap(boxes1, boxes2)
    return inter / (union + _EPS)


def bbox_giou(boxes1, boxes2):
    """Elementwise GIoU on center-format boxes (reference loss.py:34-60)."""
    inter, union, b1, b2 = _overlap(boxes1, boxes2)
    iou = inter / (union + _EPS)
    etl = torch.minimum(b1[..., :2], b2[..., :2])
    ebr = torch.maximum(b1[..., 2:], b2[..., 2:])
    ewh = ebr - etl
    enclose = ewh[..., 0] * ewh[..., 1]
    # tf.math.divide_no_nan semantics (reference loss.py:58).
    nonzero = enclose != 0.0
    frac = torch.where(nonzero, (enclose - union)
                       / torch.where(nonzero, enclose, 1.0), 0.0)
    return iou - frac


def bbox_ciou(boxes1, boxes2):
    """Elementwise CIoU on center-format boxes (reference loss.py:63-113)."""
    b1 = xywh_to_x1y1x2y2(boxes1)
    b2 = xywh_to_x1y1x2y2(boxes2)
    b1 = torch.cat([torch.minimum(b1[..., :2], b1[..., 2:]),
                    torch.maximum(b1[..., :2], b1[..., 2:])], dim=-1)
    b2 = torch.cat([torch.minimum(b2[..., :2], b2[..., 2:]),
                    torch.maximum(b2[..., :2], b2[..., 2:])], dim=-1)
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    lu = torch.maximum(b1[..., :2], b2[..., :2])
    rd = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = torch.clamp(rd - lu, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / (union + 1e-9)

    elu = torch.minimum(b1[..., :2], b2[..., :2])
    erd = torch.maximum(b1[..., 2:], b2[..., 2:])
    ewh = erd - elu
    c2 = ewh[..., 0] ** 2 + ewh[..., 1] ** 2
    p2 = ((boxes1[..., 0] - boxes2[..., 0]) ** 2
          + (boxes1[..., 1] - boxes2[..., 1]) ** 2)
    atan1 = torch.atan(boxes1[..., 2] / (boxes1[..., 3] + 1e-9))
    atan2 = torch.atan(boxes2[..., 2] / (boxes2[..., 3] + 1e-9))
    v = 4.0 * (atan1 - atan2) ** 2 / (math.pi ** 2)
    a = v / (1.0 - iou + v)
    return iou - p2 / c2 - a * v


def _sigmoid_ce(labels, logits):
    """tf.nn.sigmoid_cross_entropy_with_logits:
    max(x, 0) - x*z + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_layer(conv, pred, label, true_boxes, stride: int, num_classes: int,
               iou_loss_thresh: float, box_iou_kind: str = "giou",
               label_smoothing: float = 0.0, sample_mask=None):
    """Per-scale loss terms (reference loss.py:138-188).

    conv: (B,g,g,3*(5+C)) raw head output; pred: decode_train output
    (B,g,g,3,5+C); label: GT grid (B,g,g,3,5+C); true_boxes: (B,M,4) xywh px.
    sample_mask: optional (B,) 0/1 validity; padded samples drop out of the
    batch means.  Returns (box_loss, conf_loss, prob_loss) unweighted
    scalars.
    """
    b, g = conv.shape[0], conv.shape[1]
    input_size = float(stride * g)
    conv = conv.reshape(b, g, g, 3, 5 + num_classes)
    conv_raw_conf = conv[..., 4:5]
    conv_raw_prob = conv[..., 5:]

    pred_xywh = pred[..., 0:4]
    pred_conf = pred[..., 4:5]

    label_xywh = label[..., 0:4]
    respond_bbox = label[..., 4:5]
    label_prob = label[..., 5:]
    if label_smoothing > 0.0:
        label_prob = (label_prob * (1.0 - label_smoothing)
                      + label_smoothing / num_classes)

    iou_fn = bbox_giou if box_iou_kind == "giou" else bbox_ciou
    iou_term = iou_fn(pred_xywh, label_xywh)[..., None]

    bbox_loss_scale = 2.0 - (label_xywh[..., 2:3] * label_xywh[..., 3:4]
                             / (input_size ** 2))
    box_loss = respond_bbox * bbox_loss_scale * (1.0 - iou_term)

    prob_loss = respond_bbox * _sigmoid_ce(label_prob, conv_raw_prob)

    # Background: cells whose best IoU against any GT box is below the
    # threshold (reference loss.py:167-173).
    iou = bbox_iou(pred_xywh[:, :, :, :, None, :],
                   true_boxes[:, None, None, None, :, :])
    max_iou = iou.max(dim=-1).values[..., None]
    respond_bgd = ((1.0 - respond_bbox)
                   * (max_iou < iou_loss_thresh).to(torch.float32))

    conf_focal = (respond_bbox - pred_conf) ** 2
    ce = _sigmoid_ce(respond_bbox, conv_raw_conf)
    conf_loss = conf_focal * (respond_bbox * ce + respond_bgd * ce)

    if sample_mask is None:
        def batch_mean(t):
            return t.sum(dim=(1, 2, 3, 4)).mean()
    else:
        m = sample_mask.to(torch.float32)
        denom = torch.clamp(m.sum(), min=1.0)

        def batch_mean(t):
            return (t.sum(dim=(1, 2, 3, 4)) * m).sum() / denom
    return batch_mean(box_loss), batch_mean(conf_loss), batch_mean(prob_loss)


def yolo_loss(raw_outputs: Sequence, labels: Sequence, true_boxes,
              anchors_grouped, strides: Sequence[int], num_classes: int,
              iou_loss_thresh: float, weights=(3.54, 64.3, 1.0),
              box_iou_kind: str = "giou", label_smoothing: float = 0.0,
              return_components: bool = False, sample_mask=None):
    """Total training loss over all scales (reference loss.py:116-135).

    raw_outputs: [sbbox, mbbox, lbbox] raw grids; labels: matching GT grids;
    true_boxes: (B, max_boxes, 4) xywh pixels.
    """
    box_l = conf_l = prob_l = 0.0
    for i, (raw, label) in enumerate(zip(raw_outputs, labels)):
        if sample_mask is not None:
            # Zero the raw grids of padded samples before decode: their
            # raw wh can overflow exp() to inf, and inf*0 in the masked
            # mean is NaN.  Multiplying by the mask keeps the pad rows'
            # loss graph finite and their gradients exactly zero.
            raw = raw * sample_mask.to(raw.dtype).reshape(-1, 1, 1, 1)
        pred = decode_train(raw, anchors_grouped[i], strides[i], num_classes)
        bl, cl, pl = loss_layer(raw, pred, label, true_boxes, strides[i],
                                num_classes, iou_loss_thresh, box_iou_kind,
                                label_smoothing, sample_mask=sample_mask)
        box_l = box_l + bl
        conf_l = conf_l + cl
        prob_l = prob_l + pl

    box_l = box_l * weights[0]
    conf_l = conf_l * weights[1]
    prob_l = prob_l * weights[2]
    total = box_l + conf_l + prob_l
    if return_components:
        return total, {"box": box_l, "conf": conf_l, "prob": prob_l}
    return total
