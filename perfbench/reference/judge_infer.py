"""Judging served detections against the reference, one image at a time.

The reference decodes every anchor of the image in float32 (``decode``).
Each served detection is paired with the reference anchor it stands for:
the one nearest to it in its box and in its class's score.  Two numbers
come out, each the widest over the image:

- ``det_gap``: how far a served detection lies from its reference anchor,
  max(|box corner difference|, |score difference|) in [0, 1] units; slots
  past the valid count must be zero, and a class must name one of the C.
- ``nms_gap``: how far the served set is from being the exact combined NMS
  of the reference's values (the tf.keras reference's
  ``tf.image.combined_non_max_suppression``), taken decision by decision
  with the served set given.  Greedy per-class NMS keeps exactly the set in
  which (a) every kept box clears the score threshold, (b) no two kept
  boxes of a class overlap by more than the IoU threshold, and (c) every
  box above the threshold that is not kept overlaps, by more than the
  threshold, a kept box of its class with a higher score.  Each clause is
  read with its margin: a kept box below the threshold by its shortfall,
  two overlapping kept boxes by their excess IoU, a box left out by the
  least that would excuse it (its score's height above the threshold, the
  IoU or score order missing to a suppressor, its distance below the
  lowest kept score when the output is full, or its distance below the
  candidate cut).  Rounding moves these margins a little; a wrong answer
  moves them by a score or an overlap.  Overlaps are those of the
  unclipped boxes, as TF computes them; served boxes are clipped to [0, 1].
- ``nms_breaches``: how many of those clauses the served set breaks, in
  the image that breaks most, counting a breach only where its margin
  exceeds ``TIE``, what the served path's rounding moves a box or a score
  by (its widest gap, ``det_gap``, reads under 0.02 on the chip): a
  near-tie resolved the other way is rounding, a detection left out or
  kept against a clear margin is not.
``Readings`` reduces them over a run, with steadier numbers beside them.

The candidate cut is the port's "fast" path's documented departure: NMS
runs over the ``candidates`` anchors with the best best-class scores, so
an anchor below the K-th best best-class score may be left out.
"""

from __future__ import annotations

import numpy as np

BIG = 1.0  # gap of an answer that cannot be paired at all
TIE = 0.02  # margins up to this are near-ties that rounding may flip


def iou(a, b):
    """(n, 4) x (m, 4) corner boxes -> (n, m) IoU; 0 where the union is 0."""
    lo = np.maximum(a[:, None, :2], b[None, :, :2])
    hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(hi - lo, 0, None).prod(-1)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def judge_image(ref_boxes, ref_scores, boxes, scores, classes, n: int,
                iou_t: float, score_t: float, max_total: int,
                candidates: int, yard=None):
    """ref_boxes (N, 4) unclipped corners, ref_scores (N, C): the
    reference's decode of one image, as tensors on any device.  boxes
    (T, 4), scores (T,), classes (T,), n: what was served for it, as
    numpy.  yard: None, or (boxes, scores) of the reference computed in the
    configuration's precision (``lowp.bf16``).  Returns (det_gap, nms_gap,
    nms_breaches, the served detections' gaps, the yardstick's gaps at
    their anchors)."""
    import torch
    dev = ref_scores.device
    ref_boxes = ref_boxes.double()
    clipped = ref_boxes.clamp(0.0, 1.0)
    ref_scores = ref_scores.double()
    boxes, scores, classes = (np.nan_to_num(np.asarray(v, np.float64),
                                            nan=np.inf)
                              for v in (boxes, scores, classes))
    num, c_all = ref_scores.shape
    if not 0 <= n <= len(scores):
        return np.inf, np.inf, np.inf, np.asarray([np.inf]), np.zeros(0)
    pad = max(np.abs(boxes[n:]).max(initial=0.0),
                  np.abs(scores[n:]).max(initial=0.0),
                  np.abs(classes[n:]).max(initial=0.0))
    det_gap = pad
    cls = classes[:n]
    if np.any((cls != np.round(cls)) | (cls < 0) | (cls >= c_all)):
        return np.inf, np.inf, np.inf, np.asarray([np.inf]), np.zeros(0)
    cls = cls.astype(np.int64)
    anchor = np.zeros(0, np.int64)
    dists = yard_gaps = np.zeros(0)
    if n:
        b = torch.as_tensor(boxes[:n], device=dev)
        s = torch.as_tensor(scores[:n], device=dev)
        c = torch.as_tensor(cls, device=dev)
        d = torch.maximum((clipped[None] - b[:, None]).abs().amax(-1),
                          (ref_scores[:, c].T - s[:, None]).abs())
        gap, idx = d.min(1)
        dists = gap.cpu().numpy()
        det_gap = max(det_gap, float(dists.max()))
        anchor = idx.cpu().numpy()
        if yard is not None:
            yb = yard[0].double().clamp(0.0, 1.0)[idx]
            ys = yard[1].double()[idx, c]
            yard_gaps = torch.maximum((yb - clipped[idx]).abs().amax(-1),
                                      (ys - ref_scores[idx, c]).abs()
                                      ).cpu().numpy()
    above = ref_scores > score_t
    pairs = torch.nonzero(above).cpu().numpy()
    best = ref_scores.amax(1)
    cut = (float(torch.topk(best, candidates).values[-1])
           if num > candidates else None)
    involved = np.unique(np.concatenate([anchor, pairs[:, 0]]))
    pos = {int(a): i for i, a in enumerate(involved)}
    inv = torch.as_tensor(involved, device=dev)
    sub_boxes = ref_boxes[inv].cpu().numpy()
    sub_scores = ref_scores[inv].cpu().numpy()
    sub_best = best[inv].cpu().numpy()
    local = np.asarray([pos[int(a)] for a in anchor], np.int64)
    margins = nms_margins(sub_boxes, sub_scores, sub_best, local, cls,
                          iou_t, score_t, max_total, cut)
    return (det_gap, float(margins.max(initial=0.0)),
            int((margins > TIE).sum()),
            np.concatenate([dists, [pad]]) if pad else dists, yard_gaps)


def nms_margins(ref_boxes, ref_scores, best, anchor, cls, iou_t, score_t,
                max_total, cut):
    """The margins by which the kept pairs (anchor[j], cls[j]) break the
    three clauses of greedy NMS under the reference's values, one for each
    kept box (its shortfall below the threshold), each kept pair of a
    class that overlaps too much and each left-out box: rows of
    ``ref_boxes``, ``ref_scores`` and ``best`` (each anchor's best score)
    are the anchors involved; ``cut`` is the best score of the last
    candidate, or None where every anchor is one.  Two served detections
    that are one reference box break greedy NMS by ``BIG`` each time; the
    clauses are then read on the distinct pairs."""
    served = len(anchor)
    keys = anchor * ref_scores.shape[1] + cls
    keys, first = np.unique(keys, return_index=True)
    out = [np.full(len(anchor) - len(keys), BIG)]
    anchor, cls = anchor[first], cls[first]
    kept_s = ref_scores[anchor, cls]
    out.append(np.clip(score_t - kept_s, 0, None))
    full = served == max_total
    low = kept_s.min() if len(kept_s) else np.inf
    above = ref_scores > score_t
    above[anchor, cls] = False
    for c in np.unique(np.concatenate([cls, np.nonzero(above)[1]])):
        kc = anchor[cls == c]
        if len(kc) > 1:
            ov = iou(ref_boxes[kc], ref_boxes[kc])
            ov = ov[np.triu_indices(len(kc), 1)] - iou_t
            out.append(ov[ov > 0])
        om = np.nonzero(above[:, c])[0]
        if not len(om):
            continue
        s = ref_scores[om, c]
        excuse = s - score_t
        if full:
            excuse = np.minimum(excuse, np.clip(s - low, 0, None))
        if cut is not None:
            excuse = np.minimum(excuse, np.clip(best[om] - cut, 0, None))
        if len(kc):
            ov = iou(ref_boxes[om], ref_boxes[kc])
            order = np.clip(s[:, None] - ref_scores[kc, c][None], 0, None)
            by = np.maximum(order, np.clip(iou_t - ov, 0, None)).min(1)
            excuse = np.minimum(excuse, by)
        out.append(excuse)
    return np.concatenate(out)


def judge(ref_boxes, ref_scores, served, iou_t, score_t, max_total,
          candidates, into=None, yard=None):
    """Every image of a batch: ref_boxes (B, N, 4) and ref_scores (B, N, C)
    tensors; served = (boxes (B, T, 4), scores (B, T), classes (B, T),
    valid (B,)) as numpy.  Adds each image's readings to ``into`` (a
    ``Readings``) and returns it."""
    into = Readings() if into is None else into
    boxes, scores, classes, valid = served
    for i in range(len(valid)):
        into.add(*judge_image(
            ref_boxes[i], ref_scores[i], boxes[i], scores[i], classes[i],
            int(valid[i]), iou_t, score_t, max_total, candidates,
            None if yard is None else (yard[0][i], yard[1][i])))
    return into


class Readings:
    """The judged images of a run, reduced to the numbers ``correct`` may
    compare: the widest gaps (``det_gap``, ``nms_gap``), the most
    breaches of greedy NMS in one image (``nms_breaches``), the median gap
    of
    the served detections of every judged image together
    (``det_median``), and with a yardstick (the reference computed in the
    configuration's precision) its median gap at the same anchors
    (``yard_median``) and the ratio of the two medians (``det_ratio``):
    how far the served path's error exceeds what its precision's rounding
    alone gives on these weights."""

    def __init__(self):
        self.widest = np.zeros(3)
        self.dists, self.yard = [], []

    def add(self, det, nms, breaches, dists, yard_gaps):
        self.widest = np.maximum(self.widest, [det, nms, breaches])
        self.dists.append(dists)
        self.yard.append(yard_gaps)

    def numbers(self) -> dict:
        d = np.concatenate(self.dists) if self.dists else np.zeros(0)
        med = float(np.median(d)) if len(d) else 0.0
        out = {"det_gap": float(self.widest[0]),
               "nms_gap": float(self.widest[1]),
               "nms_breaches": float(self.widest[2]), "det_median": med}
        y = np.concatenate(self.yard) if self.yard else np.zeros(0)
        if len(y):
            ym = float(np.median(y))
            out.update(yard_median=ym, det_ratio=med / ym if ym else np.inf)
        return out
