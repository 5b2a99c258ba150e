"""Exact greedy per-class NMS in NumPy (the semantics of
``tf.image.combined_non_max_suppression``), counting the IoU tests it
makes: the work the NMS problem needs, whatever kernel computes it; and
``serve``, the combined output a served path returns, over the candidate
cut of the port's "fast" path."""

from __future__ import annotations

import numpy as np

from .judge_infer import iou


def greedy(boxes, scores, iou_t: float, score_t: float):
    """boxes (K, 4) corners (unclipped), scores (K, C) -> (kept list of
    (candidate, class) in each class's score order, IoU tests made).  A kept box is
    tested against every lower-scored box of its class still above the
    threshold and not yet suppressed."""
    kept, tests = [], 0
    for c in range(scores.shape[1]):
        idx = np.nonzero(scores[:, c] > score_t)[0]
        if not len(idx):
            continue
        idx = idx[np.argsort(-scores[idx, c], kind="stable")]
        ov = iou(boxes[idx], boxes[idx])
        alive = np.ones(len(idx), bool)
        for i in range(len(idx)):
            if not alive[i]:
                continue
            kept.append((int(idx[i]), c))
            later = np.nonzero(alive[i + 1:])[0] + i + 1
            tests += len(later)
            alive[later[ov[i, later] > iou_t]] = False
    return kept, tests


def serve(boxes, scores, iou_t: float, score_t: float, max_total: int,
          candidates: int):
    """A batch's decode, boxes (B, N, 4) unclipped corners and scores
    (B, N, C) as tensors -> what a served path returns, as numpy: boxes
    (B, T, 4) clipped to [0, 1], scores (B, T), classes (B, T) and the
    valid counts (B,), T = ``max_total``.  NMS runs over the
    ``candidates`` anchors with the best best-class scores; the kept
    pairs are merged by score, best first, and padded with zeros."""
    bx = boxes.double().cpu().numpy()
    sc = scores.double().cpu().numpy()
    b = len(bx)
    out = (np.zeros((b, max_total, 4)), np.zeros((b, max_total)),
           np.zeros((b, max_total)), np.zeros(b, np.int64))
    for i in range(b):
        top = np.argsort(-sc[i].max(1), kind="stable")[:candidates]
        kept = greedy(bx[i, top], sc[i, top], iou_t, score_t)[0]
        kept.sort(key=lambda kc: -sc[i, top[kc[0]], kc[1]])
        kept = kept[:max_total]
        for j, (k, c) in enumerate(kept):
            out[0][i, j] = np.clip(bx[i, top[k]], 0.0, 1.0)
            out[1][i, j] = sc[i, top[k], c]
            out[2][i, j] = c
        out[3][i] = len(kept)
    return out
