"""Fused detection postprocess: raw head grids -> combined-NMS outputs.

Counterpart of ``yolov4tpu.ops.detect``.  Instead of decoding all N anchor
boxes and C class scores, it:

  1. per scale: best-class score sigmoid(obj)*sigmoid(max_c logit) (sigmoid
     is monotone, so max-then-sigmoid == sigmoid-then-max);
  2. per scale top-k, then a global top-K merge of the survivors (the global
     top-K is a subset of the union of per-scale top-Ks);
  3. decodes boxes and full class scores for the K candidates only
     (the formulas of models.head.get_boxes);
  4. runs the candidate NMS tail (``nms_cuda.nms_from_candidates``).

Output-identical to decode_head -> flatten_boxes_scores ->
``combined_nms_fast``.  Every top-k here is a stable sort, the lower index
first on ties, as ``lax.top_k`` orders them: tied scores are common (a
busy scene from ``weights.force_busy_heads`` ties every hot cell).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .nms import top_k
from .nms_cuda import nms_from_candidates


def wh_exp(t):
    """YOLOv4's size decode, before the anchor: exp(t)."""
    return torch.exp(t)


def wh_scaled(t):
    """Scaled-YOLOv4's size decode, before the anchor: (2 sigmoid(t))^2."""
    return (2.0 * torch.sigmoid(t)) ** 2


WH_DECODES = {"yolov4": wh_exp, "yolov4-p6": wh_scaled}


@functools.lru_cache(maxsize=16)
def _scale_meta(grid_h: int, grid_w: int,
                anchors: Tuple[Tuple[float, float], ...], stride: int,
                xyscale: float) -> np.ndarray:
    """Per-box decode constants for one scale, flattened in (row, col,
    anchor) order — the order ``raw.reshape(B, g*g*3, 5+C)`` flattens the
    grid.  Columns: [grid_x, grid_y, anchor_w, anchor_h, stride, xyscale].
    """
    ys, xs = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    n_anchor = len(anchors)
    meta = np.empty((grid_h, grid_w, n_anchor, 6), np.float32)
    meta[..., 0] = xs[:, :, None]
    meta[..., 1] = ys[:, :, None]
    meta[..., 2] = np.asarray([a[0] for a in anchors], np.float32)
    meta[..., 3] = np.asarray([a[1] for a in anchors], np.float32)
    meta[..., 4] = stride
    meta[..., 5] = xyscale
    return meta.reshape(-1, 6)


@functools.lru_cache(maxsize=16)
def _scale_meta_cached(device: torch.device, *key) -> torch.Tensor:
    return torch.from_numpy(_scale_meta(*key)).to(device)


def _scale_meta_on(device: torch.device, *key) -> torch.Tensor:
    """``_scale_meta`` as a tensor on ``device``, copied there once.  Shared
    by every caller: read it, do not write it.  While ``torch.export``
    traces, the tensor is made anew (a constant of the program): a cached
    one would be the tracer's fake tensor."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(_scale_meta(*key)).to(device)
    return _scale_meta_cached(device, *key)


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def select_candidates(raw_outputs: Sequence[torch.Tensor], anchors_grouped,
                      num_classes: int, strides: Sequence[int],
                      xyscale: Sequence[float], img_size: int, k: int,
                      wh_decode=wh_exp):
    """Steps 1-3: raw grids -> (cand_boxes (B, K, 4) normalised corners,
    cand_scores (B, K, C)).  ``wh_decode``: the size decode before the
    anchor (``WH_DECODES``)."""
    anchors_np = np.asarray(anchors_grouped, np.float32)
    vals, logits, metas = [], [], []
    for i, raw in enumerate(raw_outputs):
        b, gh, gw = raw.shape[0], raw.shape[1], raw.shape[2]
        flat = raw.reshape(b, gh * gw * anchors_np.shape[1], 5 + num_classes)
        best = (torch.sigmoid(flat[..., 4])
                * torch.sigmoid(flat[..., 5:].max(dim=-1).values))
        v, idx = top_k(best, min(k, flat.shape[1]))              # (B, Ks)
        vals.append(v)
        logits.append(_gather_rows(flat, idx))
        meta = _scale_meta_on(
            raw.device, int(gh), int(gw),
            tuple(map(tuple, anchors_np[i].tolist())), int(strides[i]),
            float(xyscale[i]))
        metas.append(meta[idx])                                  # (B, Ks, 6)

    vals = torch.cat(vals, dim=1)
    logits = torch.cat(logits, dim=1)
    metas = torch.cat(metas, dim=1)
    _, sel = top_k(vals, min(k, vals.shape[1]))                  # (B, K)
    logits = _gather_rows(logits, sel)
    metas = _gather_rows(metas, sel)

    # Candidate decode (reference inference decode, custom_layers.py:251-257).
    grid, anchor_wh = metas[..., 0:2], metas[..., 2:4]
    stride, xysc = metas[..., 4:5], metas[..., 5:6]
    xy = ((torch.sigmoid(logits[..., 0:2]) * xysc)
          - 0.5 * (xysc - 1.0) + grid) * stride
    wh = wh_decode(logits[..., 2:4]) * anchor_wh
    cand_boxes = torch.cat([xy - wh / 2.0, xy + wh / 2.0],
                           dim=-1) / float(img_size)
    cand_scores = (torch.sigmoid(logits[..., 4:5])
                   * torch.sigmoid(logits[..., 5:]))             # (B, K, C)
    return cand_boxes, cand_scores


def detect_fused(raw_outputs: Sequence[torch.Tensor], anchors_grouped,
                 num_classes: int, strides: Sequence[int],
                 xyscale: Sequence[float], img_size: int,
                 iou_threshold: float = 0.413, score_threshold: float = 0.3,
                 max_per_class: int = 100, max_total: int = 100,
                 candidates: int = 256, clip: bool = True,
                 wh_decode=wh_exp):
    """Raw head grids -> (nmsed_boxes (B,T,4), nmsed_scores (B,T),
    nmsed_classes (B,T), valid_detections (B,)), decoding only the
    top-``candidates`` boxes.

    raw_outputs: one raw (B, g, g, A*(5+C)) NHWC grid a scale ([sbbox,
    mbbox, lbbox] for YOLOv4, four for P6).  anchors_grouped: (scales, A,
    2) pixel-unit anchors.  wh_decode: as ``select_candidates``.
    """
    device = raw_outputs[0].device
    with span("candidates", device=device):
        cand_boxes, cand_scores = select_candidates(
            raw_outputs, anchors_grouped, num_classes, strides, xyscale,
            img_size, candidates, wh_decode)
    with span("nms", device=device):
        return nms_from_candidates(cand_boxes, cand_scores, iou_threshold,
                                   score_threshold, max_per_class, max_total,
                                   clip)
