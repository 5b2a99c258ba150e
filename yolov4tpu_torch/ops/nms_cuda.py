"""Combined NMS with the hand-written CUDA suppression kernels.

Counterpart of ``yolov4tpu.ops.nms_pallas``.  Two pipelines, one per TPU
kernel:

- the fast path (``combined_nms_fast``, ``nms_impl="fast"``):
    torch: one global top-K of candidates, per-class rank matrices;
    CUDA:  greedy suppression in each class's rank order with the per-class
           cap inside the loop (csrc/suppress_rank.cu);
    torch: global top-``max_total`` merge in candidate order.
- the sorted path (``combined_nms_sorted``, ``nms_impl="pallas"``; the
  counterpart of ``combined_nms_pallas``):
    torch: per-class top-K over all N boxes, the (B, C, K, 4) box gather;
    CUDA:  greedy suppression over each class's score-sorted candidates
           (csrc/suppress.cu);
    torch: per-class cap and global top-``max_total`` merge
           (``ops.nms.finalize``, shared with the exact path).

Both kernels run one block per (class, image) in two phases: every warp
computes rows of a packed IoU bitmask (the pivots that can be live against
the later candidates, one ballot a word), then one warp scans it a word at
a time, stepping from live pivot to live pivot with ``ffs`` and shuffles
and no barrier (the sources' headers say what bounds each).  ``keep``
equals the plain version bit for bit.

Each kernel's wrapper (``suppress_rank``, ``suppress``) launches it on a
CUDA tensor and runs its plain torch version (``suppress_rank_reference``,
``suppress_reference``) on a CPU tensor; nothing else chooses between them.
The wrappers are ``torch.library`` custom ops
(``yolov4tpu_torch::suppress_rank``, ``yolov4tpu_torch::suppress``) with
fake implementations, so ``torch.export`` traces the inference path
through them (``serving.export_detector``): a ``ctypes`` launch cannot be
traced.  A program exported with them resolves the ops once this module
has been imported.  The kernels are built at first use by ``ops.build``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build as kbuild
from .nms import _finish, finalize, per_class_top_k, top_k

MAX_K = 1024  # 32 mask words: one per lane of the scanning warp

# Launches of each CUDA kernel (suppress_rank's and suppress's);
# chip_smoke.py reads them to show the main path went through the kernels.
LAUNCHES = 0
SUPPRESS_LAUNCHES = 0


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(kbuild.build("suppress_rank")))
    fn = lib.suppress_rank_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(coords, scores, rank):
    if coords.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("coords and scores must be float32")
    if rank.dtype != torch.int32:
        raise TypeError("rank must be int32")
    if coords.dim() != 3 or coords.shape[1] != 4:
        raise ValueError(f"coords must be (B, 4, K), got {tuple(coords.shape)}")
    b, _, k = coords.shape
    if scores.dim() != 3 or scores.shape[0] != b or scores.shape[2] != k:
        raise ValueError(f"scores must be (B, C, K) = ({b}, C, {k}), "
                         f"got {tuple(scores.shape)}")
    if rank.shape != scores.shape:
        raise ValueError(f"rank must match scores' shape {tuple(scores.shape)}, "
                         f"got {tuple(rank.shape)}")
    if not (coords.device == scores.device == rank.device):
        raise ValueError("coords, scores and rank must be on one device")


@torch.library.custom_op(
    "yolov4tpu_torch::suppress_rank", mutates_args=(),
    schema="(Tensor coords, Tensor scores, Tensor rank, float iou_threshold, "
           "float score_threshold, int max_per_class) -> Tensor")
def suppress_rank(coords, scores, rank, iou_threshold, score_threshold,
                  max_per_class):
    """Greedy per-class NMS in rank order with the per-class cap.

    coords (B, 4, K) float32 corner planes (x1, y1, x2, y2; lo <= hi),
    scores (B, C, K) float32, rank (B, C, K) int32 (per-class stable
    descending-score positions) -> keep (B, C, K) float32 0/1.  Each rank
    row must be a permutation of 0..K-1, as ``rank_inputs`` makes it: the
    kernel indexes shared memory with it and does not check.

    A CUDA tensor launches the kernel (and raises if the launch fails); a
    CPU tensor runs ``suppress_rank_reference``.
    """
    global LAUNCHES
    _check(coords, scores, rank)
    if coords.device.type == "cpu":
        return suppress_rank_reference(coords, scores, rank, iou_threshold,
                                       score_threshold, max_per_class)
    if coords.device.type != "cuda":
        raise ValueError(f"suppress_rank runs on cuda or cpu tensors, "
                         f"not {coords.device}")
    b, c, k = scores.shape
    if k > MAX_K:
        raise ValueError(f"K={k} candidates exceeds the kernel's {MAX_K}")
    coords, scores, rank = (t.contiguous() for t in (coords, scores, rank))
    keep = torch.empty_like(scores)
    if keep.numel() == 0:
        return keep
    launch = _library()
    with torch.cuda.device(coords.device):
        err = launch(coords.data_ptr(), scores.data_ptr(), rank.data_ptr(),
                     keep.data_ptr(), b, c, k, float(iou_threshold),
                     float(score_threshold), int(max_per_class),
                     torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"suppress_rank kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return keep


@suppress_rank.register_fake
def _suppress_rank_fake(coords, scores, rank, iou_threshold, score_threshold,
                        max_per_class):
    _check(coords, scores, rank)
    return torch.empty_like(scores)


def suppress_rank_reference(coords, scores, rank, iou_threshold: float,
                            score_threshold: float, max_per_class: int):
    """Plain-torch version of the kernel, vectorised over (B, C).

    Mirrors the Pallas body (nms_pallas.py:208-250) line by line, with the
    pivot taken by index (through perm, the inverse of rank) instead of a
    masked sum: equal for finite coordinates.  Loops to the longest valid
    prefix over the whole batch; past a class's own valid count a step
    changes nothing (the pivot was never alive).
    """
    # Thresholds rounded to float32 first, as the JAX and CUDA versions
    # compare against float32 thresholds.
    iou_t = float(np.float32(iou_threshold))
    score_t = float(np.float32(score_threshold))
    x1, y1, x2, y2 = (coords[:, j:j + 1] for j in range(4))    # (B, 1, K)
    area = (x2 - x1) * (y2 - y1)                               # (B, 1, K)
    valid = scores > score_t
    alive = valid.to(torch.float32)                            # (B, C, K)
    count = torch.zeros(scores.shape[:2] + (1,), device=scores.device)
    perm = torch.argsort(rank.long(), dim=-1)                  # rank -> cand
    nmax = int(valid.sum(dim=-1).max()) if valid.numel() else 0

    def pivot(plane, i):
        return torch.gather(plane.expand_as(scores), 2, perm[..., i:i + 1])

    for i in range(nmax):
        px1, py1, px2, py2 = (pivot(p, i) for p in (x1, y1, x2, y2))
        parea = pivot(area, i)
        palive = torch.gather(alive, 2, perm[..., i:i + 1])     # (B, C, 1)

        # Per-class cap: pivots beyond max_per_class survivors are dropped.
        newcount = count + palive
        over = (newcount > max_per_class).to(torch.float32) * palive
        palive = palive - over
        count = newcount - over
        alive = alive.scatter(2, perm[..., i:i + 1],
                              torch.gather(alive, 2, perm[..., i:i + 1]) - over)

        iw = torch.clamp(torch.minimum(px2, x2) - torch.maximum(px1, x1), min=0.0)
        ih = torch.clamp(torch.minimum(py2, y2) - torch.maximum(py1, y1), min=0.0)
        inter = iw * ih
        union = parea + area - inter
        iou = torch.where(union > 0.0, inter / union, torch.zeros_like(inter))

        suppress = (iou > iou_t) & (rank > i) & (palive > 0.5)
        alive = torch.where(suppress, torch.zeros_like(alive), alive)
    return alive


def rank_inputs(cand_boxes, cand_scores):
    """(B, K, 4) candidate boxes and (B, K, C) scores -> the kernel's inputs:
    corner planes (B, 4, K), class scores (B, C, K), per-class ranks (B, C, K)
    from stable descending sorts (``lax.sort_key_val`` on -score)."""
    sc = cand_scores.transpose(1, 2).contiguous()               # (B, C, K)
    perm = torch.sort(sc, dim=-1, descending=True, stable=True)[1]
    iota = torch.arange(sc.shape[-1], dtype=torch.int32,
                        device=sc.device).expand_as(sc)
    rank = torch.empty_like(iota).scatter_(-1, perm, iota)      # cand -> rank
    lo = torch.minimum(cand_boxes[..., :2], cand_boxes[..., 2:])
    hi = torch.maximum(cand_boxes[..., :2], cand_boxes[..., 2:])
    coords = torch.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]],
                         dim=1).contiguous()                    # (B, 4, K)
    return coords, sc, rank


def merge(keep, sc, cand_boxes, max_total: int, clip: bool):
    """Global top-``max_total`` merge over the kept (class, candidate) pairs
    -> the combined-NMS output tuple."""
    bsz, _, k = sc.shape
    flat_scores = torch.where(keep > 0.5, sc,
                              torch.full_like(sc, -1.0)).reshape(bsz, -1)
    t = min(max_total, flat_scores.shape[1])
    sel_scores, sel_idx = top_k(flat_scores, t)                 # (B, T)
    sel_classes = torch.div(sel_idx, k, rounding_mode="floor").float()
    sel_boxes = torch.gather(cand_boxes, 1,
                             (sel_idx % k)[..., None].expand(bsz, t, 4))
    return _finish(sel_boxes, sel_scores, sel_classes, max_total, clip)


def nms_from_candidates(cand_boxes, cand_scores, iou_threshold: float,
                        score_threshold: float, max_per_class: int,
                        max_total: int, clip: bool = True):
    """Combined NMS over an already-reduced candidate set.

    cand_boxes (B, K, 4) corner format, cand_scores (B, K, C) -> the
    combined-NMS output tuple.  Shared tail of ``combined_nms_fast`` and the
    fused detection path (``ops.detect``).
    """
    coords, sc, rank = rank_inputs(cand_boxes, cand_scores)
    keep = suppress_rank(coords, sc, rank, iou_threshold, score_threshold,
                         max_per_class)
    return merge(keep, sc, cand_boxes, max_total, clip)


def combined_nms_fast(boxes, scores, iou_threshold: float = 0.413,
                      score_threshold: float = 0.3, max_per_class: int = 100,
                      max_total: int = 100, candidates: int = 256,
                      clip: bool = True):
    """Combined NMS with global candidate reduction (the production path).

    Selects the top ``candidates`` boxes once by best-class score, then runs
    the per-class suppression over those only.  Equal to ``combined_nms``
    whenever at most ``candidates`` boxes clear the score threshold on
    their best class.  boxes (B, N, 4), scores (B, N, C).
    """
    bsz, n, num_classes = scores.shape
    k = min(candidates, n)
    _, cand_idx = top_k(scores.max(dim=-1).values, k)           # (B, K)
    cand_boxes = torch.gather(boxes, 1, cand_idx[..., None].expand(bsz, k, 4))
    cand_scores = torch.gather(
        scores, 1, cand_idx[..., None].expand(bsz, k, num_classes))
    return nms_from_candidates(cand_boxes, cand_scores, iou_threshold,
                               score_threshold, max_per_class, max_total, clip)


# ---------------------------------------------------------------------------
# The sorted path: per-class top-K, csrc/suppress.cu, cap and merge
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _suppress_library():
    lib = ctypes.CDLL(str(kbuild.build("suppress")))
    fn = lib.suppress_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_sorted(coords, valid):
    if coords.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError("coords and valid must be float32")
    if coords.dim() != 4 or coords.shape[1] != 4:
        raise ValueError(f"coords must be (B, 4, C, K), got "
                         f"{tuple(coords.shape)}")
    b, _, c, k = coords.shape
    if tuple(valid.shape) != (b, c, k):
        raise ValueError(f"valid must be (B, C, K) = ({b}, {c}, {k}), got "
                         f"{tuple(valid.shape)}")
    if coords.device != valid.device:
        raise ValueError("coords and valid must be on one device")
    if k > MAX_K:
        raise ValueError(f"K={k} candidates exceeds the suppress kernel's "
                         f"limit of {MAX_K}")


def _loop_bounds(valid):
    """Each image's loop bound, as the Pallas kernel computes it
    (nms_pallas.py:56): the largest valid count of any class, truncated to
    int32.  (B,) int32."""
    return valid.sum(dim=-1).amax(dim=-1).to(torch.int32)


@torch.library.custom_op(
    "yolov4tpu_torch::suppress", mutates_args=(),
    schema="(Tensor coords, Tensor valid, float iou_threshold) -> Tensor")
def suppress(coords, valid, iou_threshold):
    """Greedy per-class NMS over score-sorted candidates.

    coords (B, 4, C, K) float32 corner planes (x1, y1, x2, y2; lo <= hi) of
    each class's candidates in descending-score order, valid (B, C, K)
    float32 0/1 -> keep (B, C, K) float32: ``valid`` with 0 wherever a live
    earlier candidate of the class overlaps by IoU > ``iou_threshold``.
    Each image loops to its largest per-class valid count, as the TPU
    kernel does, so any 0/1 mask gives the TPU kernel's result.  K is at
    most 1024 (one mask word per lane of the scanning warp), on either
    device.

    A CUDA tensor launches the kernel (and raises if the launch fails); a
    CPU tensor runs ``suppress_reference``.
    """
    global SUPPRESS_LAUNCHES
    _check_sorted(coords, valid)
    if coords.device.type == "cpu":
        return suppress_reference(coords, valid, iou_threshold)
    if coords.device.type != "cuda":
        raise ValueError(f"suppress runs on cuda or cpu tensors, not "
                         f"{coords.device}")
    b, _, c, k = coords.shape
    coords, valid = coords.contiguous(), valid.contiguous()
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    nmax = _loop_bounds(valid)
    launch = _suppress_library()
    with torch.cuda.device(coords.device):
        err = launch(coords.data_ptr(), valid.data_ptr(), nmax.data_ptr(),
                     keep.data_ptr(), b, c, k, float(iou_threshold),
                     torch.cuda.current_stream(coords.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"suppress kernel launch failed: CUDA error {err}")
    SUPPRESS_LAUNCHES += 1
    return keep


@suppress.register_fake
def _suppress_fake(coords, valid, iou_threshold):
    _check_sorted(coords, valid)
    return torch.empty_like(valid)


def suppress_reference(coords, valid, iou_threshold: float):
    """Plain-torch version of the kernel, vectorised over (B, C).

    Mirrors the Pallas body (nms_pallas.py:46-82) line by line, with the
    pivot taken by index instead of a masked sum (equal for finite
    coordinates).  Steps run to the batch's largest loop bound; a step past
    an image's own bound changes nothing in it.
    """
    # The threshold rounded to float32 first, as the JAX and CUDA versions
    # compare against a float32 threshold.
    iou_t = float(np.float32(iou_threshold))
    alive = valid.clone()
    if alive.numel() == 0:
        return alive
    x1, y1, x2, y2 = coords.unbind(dim=1)                      # (B, C, K)
    area = (x2 - x1) * (y2 - y1)
    nmax = _loop_bounds(valid)[:, None, None]                  # (B, 1, 1)
    col = torch.arange(valid.shape[-1], device=valid.device)
    for i in range(int(nmax.max())):
        px1, py1, px2, py2 = (p[..., i:i + 1] for p in (x1, y1, x2, y2))
        parea = area[..., i:i + 1]
        palive = alive[..., i:i + 1]                           # (B, C, 1)

        iw = torch.clamp(torch.minimum(px2, x2) - torch.maximum(px1, x1), min=0.0)
        ih = torch.clamp(torch.minimum(py2, y2) - torch.maximum(py1, y1), min=0.0)
        inter = iw * ih
        union = parea + area - inter
        iou = torch.where(union > 0.0, inter / union, torch.zeros_like(inter))

        suppress_ = ((iou > iou_t) & (col > i) & (palive > 0.5)
                     & (i < nmax))
        alive = torch.where(suppress_, torch.zeros_like(alive), alive)
    return alive


def sorted_inputs(boxes, scores, score_threshold: float, pre_top_k: int):
    """Stage 1 of the sorted path: boxes (B, N, 4), scores (B, N, C) ->
    each class's top-``pre_top_k`` scores (B, C, K) and boxes (B, C, K, 4),
    and the kernel's inputs: corner planes (B, 4, C, K) with lo <= hi and
    the valid mask (B, C, K)."""
    top_scores, top_boxes = per_class_top_k(boxes, scores, pre_top_k)
    # Canonical corner order, as the exact path and TF treat degenerate boxes.
    lo = torch.minimum(top_boxes[..., :2], top_boxes[..., 2:])
    hi = torch.maximum(top_boxes[..., :2], top_boxes[..., 2:])
    coords = torch.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]],
                         dim=1).contiguous()                    # (B,4,C,K)
    valid = (top_scores > score_threshold).to(torch.float32)
    return top_scores, top_boxes, coords, valid


def combined_nms_sorted(boxes, scores, iou_threshold: float = 0.413,
                        score_threshold: float = 0.3, max_per_class: int = 100,
                        max_total: int = 100, pre_top_k: int = 256,
                        clip: bool = True):
    """Batched combined NMS with the suppression kernel over each class's
    own score-sorted candidates: the counterpart of
    ``yolov4tpu.ops.nms_pallas.combined_nms_pallas`` (``nms_impl="pallas"``).

    Same contract as ``ops.nms.combined_nms``, and exact for any number of
    boxes above the threshold (unlike ``combined_nms_fast``): boxes
    (B, N, 4) corner format, scores (B, N, C) -> (nmsed_boxes (B,T,4),
    nmsed_scores (B,T), nmsed_classes (B,T), valid_detections (B,)),
    T = max_total.
    """
    top_scores, top_boxes, coords, valid = sorted_inputs(
        boxes, scores, score_threshold, pre_top_k)
    keep = suppress(coords, valid, iou_threshold)
    return finalize(top_scores, top_boxes, keep > 0.5, max_per_class,
                    max_total, clip)
