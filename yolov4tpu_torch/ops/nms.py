"""Exact TF-semantics combined (per-class) NMS in plain torch.

Counterpart of ``yolov4tpu.ops.nms.combined_nms``, the reference's
``tf.image.combined_non_max_suppression`` (reference custom_layers.py:290-297):
per-class greedy suppression over boxes sorted by score (ties broken by lower
index), score_threshold filtering, per-class cap, then a global
top-``max_total`` merge by score, outputs zero-padded, boxes clipped to
[0,1].  It is the oracle for the suppression kernels, and it serves
``nms_impl="xla"``.  ``nms`` is the facade entry point over decoded head
outputs, as in the JAX package.
"""

from __future__ import annotations

import torch


def top_k(x, k: int):
    """``lax.top_k`` semantics: the k largest along the last axis, the lower
    index first on ties (``torch.topk`` promises no tie order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def pairwise_iou_corners(a, b):
    """IoU between corner-format box sets: (..., N, 4), (..., M, 4) ->
    (..., N, M).  Corner order is normalised first, as TF does."""
    a = torch.cat([torch.minimum(a[..., :2], a[..., 2:]),
                   torch.maximum(a[..., :2], a[..., 2:])], dim=-1)
    b = torch.cat([torch.minimum(b[..., :2], b[..., 2:]),
                   torch.maximum(b[..., :2], b[..., 2:])], dim=-1)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def combined_nms(boxes, scores, iou_threshold: float = 0.413,
                 score_threshold: float = 0.3, max_per_class: int = 100,
                 max_total: int = 100, pre_top_k: int = 256, clip: bool = True):
    """Batched combined NMS.

    boxes: (B, N, 4) corner boxes; scores: (B, N, C) per-class scores.
    Returns (nmsed_boxes (B,T,4), nmsed_scores (B,T), nmsed_classes (B,T),
    valid_detections (B,) int32) with T = max_total, zero-padded.
    """
    top_scores, top_boxes = per_class_top_k(boxes, scores, pre_top_k)
    k = top_scores.shape[-1]
    iou = pairwise_iou_corners(top_boxes, top_boxes)             # (B,C,K,K)
    later = torch.arange(k, device=boxes.device)
    later = later[None, :] > later[:, None]                      # idx > i
    alive = top_scores > score_threshold
    for i in range(k):
        row = (iou[..., i, :] > iou_threshold) & later[i]
        alive = alive & ~(row & alive[..., i:i + 1])
    return finalize(top_scores, top_boxes, alive, max_per_class, max_total,
                    clip)


def per_class_top_k(boxes, scores, pre_top_k: int):
    """Each class's ``pre_top_k`` best boxes: boxes (B, N, 4), scores
    (B, N, C) -> top_scores (B, C, K) descending (lower index first on
    ties), top_boxes (B, C, K, 4), K = min(pre_top_k, N)."""
    bsz, n, num_classes = scores.shape
    k = min(pre_top_k, n)
    top_scores, top_idx = top_k(scores.transpose(1, 2), k)       # (B, C, K)
    top_boxes = torch.gather(
        boxes[:, None].expand(bsz, num_classes, n, 4), 2,
        top_idx[..., None].expand(bsz, num_classes, k, 4))       # (B,C,K,4)
    return top_scores, top_boxes


def finalize(top_scores, top_boxes, keep, max_per_class: int,
             max_total: int, clip: bool):
    """Per-class cap and global top-``max_total`` merge (counterpart of
    ``nms_pallas._finalize``): top_scores (B, C, K), top_boxes (B, C, K, 4)
    and the bool survivors ``keep`` (B, C, K), each class's in score order
    -> the combined-NMS output tuple."""
    bsz, _, k = top_scores.shape
    rank = torch.cumsum(keep.to(torch.int32), dim=-1)            # per-class cap
    keep = keep & (rank <= max_per_class)
    flat_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, -1.0)
                              ).reshape(bsz, -1)
    flat_boxes = top_boxes.reshape(bsz, -1, 4)
    t = min(max_total, flat_scores.shape[1])
    sel_scores, sel_idx = top_k(flat_scores, t)
    sel_boxes = torch.gather(flat_boxes, 1, sel_idx[..., None].expand(bsz, t, 4))
    sel_classes = torch.div(sel_idx, k, rounding_mode="floor").float()
    return _finish(sel_boxes, sel_scores, sel_classes, max_total, clip)


def _finish(sel_boxes, sel_scores, sel_classes, max_total: int, clip: bool):
    """Zero the slots past the valid detections, clip, pad to max_total."""
    valid = sel_scores > 0.0
    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    zero = torch.zeros_like(sel_scores)
    sel_scores = torch.where(valid, sel_scores, zero)
    sel_classes = torch.where(valid, sel_classes, zero)
    sel_boxes = torch.where(valid[..., None], sel_boxes,
                            torch.zeros_like(sel_boxes))
    if clip:
        sel_boxes = torch.clamp(sel_boxes, 0.0, 1.0)
    pad = max_total - sel_scores.shape[1]
    if pad > 0:
        sel_scores = torch.nn.functional.pad(sel_scores, (0, pad))
        sel_classes = torch.nn.functional.pad(sel_classes, (0, pad))
        sel_boxes = torch.nn.functional.pad(sel_boxes, (0, 0, 0, pad))
    return sel_boxes, sel_scores, sel_classes, n_valid


def nms(head_outputs, img_size, num_classes: int, iou_threshold: float = 0.413,
        score_threshold: float = 0.3, max_total: int = 100,
        pre_top_k: int = 256, use_pallas: bool = False):
    """Reference-facade NMS entry point (reference custom_layers.py:261-298;
    counterpart of ``yolov4tpu.ops.nms.nms``).

    head_outputs: the 12-element decode list from ``decode_head``.
    img_size: (H, W, C) tuple or int; boxes are normalised by its first entry.
    ``use_pallas=True`` (the JAX package's name) runs the sorted path with
    the CUDA suppression kernel, ``nms_cuda.combined_nms_sorted``, with its
    default per-class cap of 100 as the JAX package does.
    Returns (boxes, scores, classes, valid_detections).
    """
    from ..models.head import flatten_boxes_scores
    size = img_size[0] if hasattr(img_size, "__len__") else img_size
    boxes, scores = flatten_boxes_scores(head_outputs, size, num_classes)
    if use_pallas:
        from .nms_cuda import combined_nms_sorted
        return combined_nms_sorted(
            boxes, scores, iou_threshold=iou_threshold,
            score_threshold=score_threshold, max_total=max_total,
            pre_top_k=pre_top_k)
    return combined_nms(boxes, scores, iou_threshold=iou_threshold,
                        score_threshold=score_threshold,
                        max_per_class=max_total, max_total=max_total,
                        pre_top_k=pre_top_k)
