"""The two-phase design of the CUDA suppression kernels (``csrc/suppress.cu``
and ``csrc/suppress_rank.cu``), modelled in numpy and held bit for bit to
the Pallas kernels in interpret mode and to the plain versions.

The kernels cannot run on the CPU, so this file checks their algorithm: a
packed uint32 IoU bitmask computed in float32 with the kernels' order of
operations (phase 1), then the scan of one warp over up to 32 words, a
word at a time, which steps from live pivot to live pivot with ``ffs`` and
so skips dead pivots (phase 2), with the per-class cap's stop
(``suppress_rank``) and the per-image loop bound with the float mask
passed through (``suppress``).
Mask words the kernels never compute (left of the diagonal, rows that can
never be pivots) are filled with ones here, so a scan that read them would
fail.  The chip run (``chip_smoke.py``) holds the kernels themselves to the
plain versions on the card at the same kinds of input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4tpu.ops import nms_pallas as jpallas
from yolov4tpu_torch.ops import nms_cuda

WARP = 32
UNCOMPUTED = np.uint32(0xFFFFFFFF)


# ---------------------------------------------------------------------------
# The numpy model
# ---------------------------------------------------------------------------

def iou_over(px, x, iou_t):
    """(rows, cols) bool: IoU(pivot row, candidate col) > iou_t, in float32
    with the kernels' operations in their order: a true division where
    uni > 0, left out (quotient 0) where the intersection is 0, as the
    kernels do.  px and x are (4, n) corner planes."""
    f32 = np.float32
    area_p = (px[2] - px[0]) * (px[3] - px[1])
    area = (x[2] - x[0]) * (x[3] - x[1])
    iw = np.maximum(np.minimum(px[2][:, None], x[2][None])
                    - np.maximum(px[0][:, None], x[0][None]), f32(0))
    ih = np.maximum(np.minimum(px[3][:, None], x[3][None])
                    - np.maximum(px[1][:, None], x[1][None]), f32(0))
    inter = iw * ih
    uni = (area_p[:, None] + area[None]) - inter
    iou = np.zeros_like(inter)
    np.divide(inter, uni, out=iou, where=(uni > 0) & (inter > 0))
    assert iou.dtype == np.float32
    return iou > f32(iou_t)


def pack(bits, words):
    """(rows, cols) bool -> (rows, words) uint32, bit j % 32 of word j / 32."""
    rows, cols = bits.shape
    padded = np.zeros((rows, words * WARP), bool)
    padded[:, :cols] = bits
    weights = (np.uint64(1) << np.arange(WARP, dtype=np.uint64))
    return (padded.reshape(rows, words, WARP) * weights).sum(-1).astype(
        np.uint32)


def bitmask(corners, rows, cols, words, iou_t):
    """Phase 1: the (K, words) mask of the pivot rows ``rows`` against the
    tested columns ``cols`` after each row (both bool, one per candidate);
    every word a kernel does not compute is UNCOMPUTED."""
    k = corners.shape[1]
    over = iou_over(corners, corners, iou_t) & cols[None]
    over &= np.arange(k)[None] > np.arange(k)[:, None]         # j > i only
    mask = pack(over[:, :words * WARP], words)
    left = np.arange(words)[None] < (np.arange(k) // WARP)[:, None]
    mask[left | ~rows[:, None]] = UNCOMPUTED
    return mask


def ffs(word):
    """Lowest set bit of a nonzero word, as __ffs(word) - 1."""
    word = int(word)
    return (word & -word).bit_length() - 1


def scan(mask, todo, removed, words, cap=None):
    """Phase 2, one warp, a word at a time: lane l holds removed[l].  For
    word w, its live pivots (todo & ~removed), the diagonal mask word of
    each live row (one load a lane), the pivots of the word in order from
    those words alone (ffs, one shuffle each), then the kept rows' later
    words OR-ed into lanes w+1 .. words-1.  With a cap, the scan stops once
    ``cap`` pivots are kept and removes every later one.  Returns
    (removed, steps): steps are the kept pivots."""
    removed = removed.copy()
    steps = 0
    if cap is not None and cap <= 0:
        return np.full(WARP, UNCOMPUTED), 0
    for w in range(words):
        live = int(todo[w] & ~removed[w])               # __shfl_sync
        if not live:
            continue
        diag = {r: int(mask[w * WARP + r, w])
                for r in range(WARP) if live >> r & 1}
        kept = gone = 0
        while live:
            bit = ffs(live)
            suppressed = diag[bit]                      # __shfl_sync
            kept |= 1 << bit
            gone |= suppressed
            live &= ~suppressed & ~(1 << bit)
            steps += 1
            if cap is not None and steps == cap:
                removed[w] |= np.uint32(gone | live)    # past the cap
                removed[w + 1:] |= todo[w + 1:]
                return removed, steps
        removed[w] |= np.uint32(gone)
        while kept:
            i = w * WARP + ffs(kept)
            kept &= kept - 1
            removed[w + 1:words] |= mask[i, w + 1:words]
    return removed, steps


def bit_of(words, j):
    return (words[j // WARP] >> np.uint32(j % WARP)) & np.uint32(1)


def model_suppress_rank(coords, scores, rank, iou_t, score_t, cap):
    """suppress_rank.cu's algorithm on numpy inputs (B,4,K), (B,C,K) x2 ->
    (keep (B,C,K) float32, scan steps (B,C))."""
    b, c, k = scores.shape
    keep = np.zeros((b, c, k), np.float32)
    steps = np.zeros((b, c), int)
    for bi in range(b):
        for ci in range(c):
            r = rank[bi, ci]
            nvalid = int((scores[bi, ci] > np.float32(score_t)).sum())
            ranked = np.empty((4, k), np.float32)
            ranked[:, r] = coords[bi]                 # corners in rank order
            words = -(-nvalid // WARP)
            below = np.arange(k) < nvalid
            mask = bitmask(ranked, below, below, words, iou_t)
            lane = np.arange(WARP) * WARP
            removed = np.where(nvalid >= lane + WARP, 0, np.where(
                nvalid > lane, (0xFFFFFFFF << np.clip(nvalid - lane, 0, 31))
                & 0xFFFFFFFF, 0xFFFFFFFF)).astype(np.uint32)
            removed, steps[bi, ci] = scan(mask, ~removed, removed, words, cap)
            keep[bi, ci] = [0.0 if bit_of(removed, int(r[t])) else 1.0
                            for t in range(k)]
    return keep, steps


def model_suppress(coords, valid, iou_t):
    """suppress.cu's algorithm on numpy inputs (B,4,C,K), (B,C,K) ->
    (keep (B,C,K) float32, scan steps (B,C))."""
    b, _, c, k = coords.shape
    nmax = nms_cuda._loop_bounds(torch.from_numpy(valid)).numpy()
    keep = np.zeros((b, c, k), np.float32)
    steps = np.zeros((b, c), int)
    for bi in range(b):
        n = int(np.clip(nmax[bi], 0, k))
        for ci in range(c):
            v = valid[bi, ci]
            pivots = (v > 0.5) & (np.arange(k) < n)
            # A candidate whose valid is 0 is not tested (clearing it
            # changes no keep), so the rows span the words up to the last
            # one holding a nonzero valid.
            nonzero = np.flatnonzero(v != 0)
            words = int(nonzero[-1]) // WARP + 1 if nonzero.size else 0
            mask = bitmask(coords[bi, :, ci], pivots, v != 0, words, iou_t)
            todo = np.zeros(WARP, np.uint32)
            todo[:words] = pack(pivots[None, :words * WARP], words)[0]
            removed, steps[bi, ci] = scan(
                mask, todo, np.zeros(WARP, np.uint32), words)
            keep[bi, ci] = [0.0 if bit_of(removed, t) else v[t]
                            for t in range(k)]
    return keep, steps


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _corner_planes(rng, shape):
    """Clustered boxes (many overlaps), corners swapped on some, some of
    zero area; returned as lo <= hi corner planes stacked on axis 1."""
    n = int(np.prod(shape))
    centers = rng.uniform(0.2, 0.8, (max(n // 6, 1), 2))
    xy = (centers[rng.integers(0, len(centers), n)]
          + rng.normal(0, 0.02, (n, 2)))
    wh = rng.uniform(0.05, 0.25, (n, 2))
    wh[rng.uniform(size=n) < 0.03] = 0.0
    boxes = np.clip(np.concatenate([xy - wh / 2, xy + wh / 2], -1), 0, 1)
    boxes = boxes.astype(np.float32).reshape(*shape, 4)
    lo = np.minimum(boxes[..., :2], boxes[..., 2:])
    hi = np.maximum(boxes[..., :2], boxes[..., 2:])
    return np.ascontiguousarray(
        np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], 1))


def _rank_case(rng, b, c, k, kind, counts=None):
    coords = _corner_planes(rng, (b, k))
    scores = rng.uniform(0, 1, (b, c, k)).astype(np.float32)
    if kind == "ties":
        scores = (np.round(scores / 0.05) * 0.05).astype(np.float32)
    elif kind == "empty":
        scores *= np.float32(0.25)                  # nothing clears 0.3
    elif kind == "counts":        # class ci has exactly counts[ci] valid
        for ci, n in enumerate(counts):
            above = rng.permutation(k) < n
            scores[:, ci] = np.where(above, 0.3 + 0.7 * scores[:, ci],
                                     0.3 * scores[:, ci])
    perm = np.argsort(-scores, axis=-1, kind="stable")
    rank = np.empty_like(perm)
    np.put_along_axis(rank, perm, np.arange(k)[None, None], axis=-1)
    return coords, scores, rank.astype(np.int32)


def _sorted_case(rng, b, c, k, kind):
    coords = _corner_planes(rng, (b, c, k))
    if kind == "prefix":
        valid = np.arange(k) < rng.integers(0, k + 1, (b, c, 1))
    elif kind == "non-prefix":
        valid = rng.uniform(size=(b, c, k)) < 0.3
    elif kind == "all":
        valid = np.ones((b, c, k), bool)
    else:
        valid = np.zeros((b, c, k), bool)
    return coords, valid.astype(np.float32)


# ---------------------------------------------------------------------------
# suppress_rank
# ---------------------------------------------------------------------------

RANK_CASES = [
    # (B, C, K, kind, cap, per-class valid counts)
    (2, 3, 31, "random", 100, None),
    (2, 3, 32, "random", 100, None),
    (2, 3, 33, "random", 100, None),         # one bit in the second word
    (2, 3, 64, "ties", 100, None),
    (1, 3, 100, "random", 100, None),
    (2, 3, 64, "ties", 0, None),             # the cap keeps nothing
    (2, 3, 64, "random", 1, None),
    (2, 3, 64, "ties", 3, None),
    (2, 3, 64, "empty", 100, None),
    (1, 4, 100, "counts", 100, (31, 32, 33, 64)),   # word edges
    (1, 4, 100, "counts", 5, (31, 32, 33, 64)),
]


@pytest.mark.parametrize("b,c,k,kind,cap,counts", RANK_CASES)
def test_suppress_rank_model_matches_pallas(rng, b, c, k, kind, cap, counts):
    iou_t, score_t = 0.413, 0.3
    coords, scores, rank = _rank_case(rng, b, c, k, kind, counts)
    got, steps = model_suppress_rank(coords, scores, rank, iou_t, score_t,
                                     cap)
    want = np.asarray(jpallas._suppress_rank_batch(
        jnp.asarray(coords), jnp.asarray(scores), jnp.asarray(rank), iou_t,
        score_t, cap, interpret=True))
    np.testing.assert_array_equal(got, want)
    plain = nms_cuda.suppress_rank_reference(
        *(torch.from_numpy(a) for a in (coords, scores, rank)), iou_t,
        score_t, cap)
    np.testing.assert_array_equal(got, plain.numpy())
    # One scan step per kept pivot: dead pivots cost nothing.
    np.testing.assert_array_equal(steps, want.sum(-1))
    if counts is not None:
        np.testing.assert_array_equal(
            (scores > score_t).sum(-1), np.broadcast_to(counts, (b, c)))
    if kind == "empty" or cap == 0:
        assert not got.any()
    assert got.sum(-1).max() <= max(cap, 0)


def test_suppress_rank_model_at_1024(rng):
    """K = 1024: every lane of the scanning warp holds a word."""
    iou_t, score_t, cap = 0.413, 0.0, 1000
    coords, scores, rank = _rank_case(rng, 1, 2, 1024, "random")
    got, steps = model_suppress_rank(coords, scores, rank, iou_t, score_t,
                                     cap)
    plain = nms_cuda.suppress_rank_reference(
        *(torch.from_numpy(a) for a in (coords, scores, rank)), iou_t,
        score_t, cap)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(steps, got.sum(-1))
    # Candidates ranked in the last word survive somewhere.
    last = rank >= 992
    assert (got.astype(bool) & last).any()


# ---------------------------------------------------------------------------
# suppress
# ---------------------------------------------------------------------------

SORTED_CASES = [
    (2, 3, 31, "prefix"),
    (2, 3, 32, "prefix"),
    (2, 3, 33, "prefix"),
    (2, 3, 64, "all"),
    (2, 3, 100, "prefix"),
    (2, 3, 64, "non-prefix"),
    (2, 3, 100, "non-prefix"),
    (2, 3, 64, "empty"),
]


@pytest.mark.parametrize("b,c,k,kind", SORTED_CASES)
def test_suppress_model_matches_pallas(rng, b, c, k, kind):
    iou_t = 0.413
    coords, valid = _sorted_case(rng, b, c, k, kind)
    got, steps = model_suppress(coords, valid, iou_t)
    want = np.asarray(jpallas._suppress_batch(
        jnp.asarray(coords), jnp.asarray(valid), iou_t, interpret=True))
    np.testing.assert_array_equal(got, want)
    plain = nms_cuda.suppress_reference(torch.from_numpy(coords),
                                        torch.from_numpy(valid), iou_t)
    np.testing.assert_array_equal(got, plain.numpy())
    # One scan step per surviving pivot below the image's loop bound.
    nmax = valid.sum(-1).max(-1).astype(int)
    pivots = (np.arange(k) < nmax[:, None, None]) & (valid > 0.5)
    np.testing.assert_array_equal(steps, (pivots & (got > 0.5)).sum(-1))
    if kind == "non-prefix":
        # The image-wide bound sits below some class's last valid index,
        # so candidates past it are never pivots, as in the TPU kernel.
        last = k - 1 - np.argmax(valid[..., ::-1] > 0, axis=-1)
        assert (last >= nmax[:, None]).any()
    if kind == "empty":
        assert not got.any()
    else:
        assert (got < valid).any()


def test_suppress_model_passes_float_masks_through(rng):
    """valid values other than 0/1 come out as they went in unless a live
    pivot clears them, as suppress_reference's alive = valid.clone()."""
    coords, _ = _sorted_case(rng, 2, 3, 64, "all")
    valid = rng.choice(np.float32([0.0, 0.3, 0.5, 0.7, 1.0, 2.0]),
                       (2, 3, 64)).astype(np.float32)
    got, _ = model_suppress(coords, valid, 0.413)
    plain = nms_cuda.suppress_reference(torch.from_numpy(coords),
                                        torch.from_numpy(valid), 0.413)
    np.testing.assert_array_equal(got, plain.numpy())
    assert set(np.unique(got)) - {0.0} <= set(np.unique(valid))
    assert (got == np.float32(0.3)).any() and (got < valid).any()


def test_suppress_model_at_1024(rng):
    """K = 1024, dense: 32 words a row, every lane of the scanning warp."""
    coords, valid = _sorted_case(rng, 1, 2, 1024, "all")
    got, steps = model_suppress(coords, valid, 0.413)
    plain = nms_cuda.suppress_reference(torch.from_numpy(coords),
                                        torch.from_numpy(valid), 0.413)
    np.testing.assert_array_equal(got, plain.numpy())
    np.testing.assert_array_equal(steps, got.sum(-1))
    assert got[..., 992:].any()
