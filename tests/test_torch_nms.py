"""The port's NMS (yolov4tpu_torch.ops.nms and ops.nms_cuda) against the JAX
package's, on the same numpy inputs.

``suppress_rank_reference`` — the plain torch version of the CUDA
suppression kernel, which ``suppress_rank`` runs for CPU tensors — is held
to the Pallas kernel ``_suppress_rank_kernel`` run in interpret mode:
``keep`` exactly equal, on random and tie-heavy scores, with a per-class cap
that bites, an all-empty batch and K not a multiple of 32.  The NMS
pipelines around it see identical inputs and do identical float32
arithmetic, so their outputs are compared exactly too.  (The CUDA kernel
itself is compared with ``suppress_rank_reference`` on the card by
chip_smoke.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_parity import assert_detections_equal
from yolov4tpu.ops.nms import combined_nms as jax_combined_nms
from yolov4tpu.ops import nms_pallas as jpallas
from yolov4tpu_torch.ops import nms as tnms
from yolov4tpu_torch.ops import nms_cuda


def _boxes(rng, shape, degenerate=0.0):
    """Clustered corner boxes in [0, 1] (many overlaps), some with their
    corners swapped and, optionally, some of zero area."""
    n = int(np.prod(shape))
    centers = rng.uniform(0.2, 0.8, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 0.02, (n, 2))
    wh = rng.uniform(0.05, 0.25, (n, 2))
    wh[rng.uniform(size=n) < degenerate] = 0.0
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    swap = rng.uniform(size=n) < 0.1
    boxes[swap] = boxes[swap][:, [2, 3, 0, 1]]
    return np.clip(boxes, 0, 1).astype(np.float32).reshape(*shape, 4)


def _scores(rng, shape, kind):
    s = rng.uniform(0, 1, shape)
    if kind == "ties":
        s = np.round(s / 0.05) * 0.05           # steps of 0.05: many ties
    elif kind == "empty":
        s = s * 0.25                            # nothing clears 0.3
    return s.astype(np.float32)


def _rank_inputs(rng, b, c, k, kind):
    """The kernel's inputs as numpy: coords (B,4,K) lo<=hi, scores (B,C,K),
    rank (B,C,K) from a stable descending sort (as ``lax.sort_key_val``)."""
    boxes = _boxes(rng, (b, k), degenerate=0.05)
    lo = np.minimum(boxes[..., :2], boxes[..., 2:])
    hi = np.maximum(boxes[..., :2], boxes[..., 2:])
    coords = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], 1)
    scores = _scores(rng, (b, c, k), kind)
    perm = np.argsort(-scores, axis=-1, kind="stable")
    rank = np.empty_like(perm)
    np.put_along_axis(rank, perm, np.arange(k)[None, None], axis=-1)
    return coords, scores, rank.astype(np.int32)


@pytest.mark.parametrize("b,c,k,iou_t,score_t,max_per_class,kind", [
    (2, 5, 64, 0.413, 0.3, 100, "random"),
    (2, 6, 96, 0.413, 0.3, 100, "ties"),
    (2, 4, 64, 0.5, 0.2, 3, "ties"),          # the cap bites
    (3, 3, 64, 0.413, 0.3, 100, "empty"),
    (1, 4, 100, 0.3, 0.1, 7, "random"),       # K not a multiple of 32
    (2, 2, 37, 0.45, 0.05, 1, "ties"),
])
def test_suppress_rank_reference_matches_pallas(rng, b, c, k, iou_t, score_t,
                                                max_per_class, kind):
    coords, scores, rank = _rank_inputs(rng, b, c, k, kind)
    want = np.asarray(jpallas._suppress_rank_batch(
        jnp.asarray(coords), jnp.asarray(scores), jnp.asarray(rank), iou_t,
        score_t, max_per_class, interpret=True))
    args = [torch.from_numpy(a) for a in (coords, scores, rank)]
    got = nms_cuda.suppress_rank_reference(*args, iou_t, score_t,
                                           max_per_class)
    assert got.dtype == torch.float32 and got.shape == (b, c, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # On CPU tensors the kernel's wrapper runs exactly this plain version.
    launches = nms_cuda.LAUNCHES
    np.testing.assert_array_equal(
        nms_cuda.suppress_rank(*args, iou_t, score_t, max_per_class).numpy(),
        want)
    assert nms_cuda.LAUNCHES == launches
    if kind == "empty":
        assert not want.any()
    if max_per_class < 100:
        assert want.sum(-1).max() <= max_per_class


def test_suppress_rank_checks_its_inputs(rng):
    coords, scores, rank = (torch.from_numpy(a)
                            for a in _rank_inputs(rng, 1, 2, 32, "random"))
    with pytest.raises(TypeError):
        nms_cuda.suppress_rank(coords.double(), scores, rank, 0.4, 0.3, 10)
    with pytest.raises(TypeError):
        nms_cuda.suppress_rank(coords, scores, rank.long(), 0.4, 0.3, 10)
    with pytest.raises(ValueError):
        nms_cuda.suppress_rank(coords[:, :3], scores, rank, 0.4, 0.3, 10)
    with pytest.raises(ValueError):
        nms_cuda.suppress_rank(coords, scores[:, :, :16], rank, 0.4, 0.3, 10)
    with pytest.raises(ValueError):
        nms_cuda.suppress_rank(coords, scores, rank[:, :1], 0.4, 0.3, 10)


@pytest.mark.parametrize("num_classes,kind,max_per_class,max_total", [
    (3, "random", 100, 100),
    (8, "ties", 100, 100),
    (8, "ties", 4, 20),
    (3, "empty", 100, 100),
])
def test_nms_from_candidates_matches_jax(rng, num_classes, kind,
                                         max_per_class, max_total):
    b, k = 2, 100
    boxes = _boxes(rng, (b, k))
    scores = _scores(rng, (b, k, num_classes), kind)
    want = jpallas.nms_from_candidates(
        jnp.asarray(boxes), jnp.asarray(scores), 0.413, 0.3, max_per_class,
        max_total, True, interpret=True)
    got = nms_cuda.nms_from_candidates(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.413, 0.3,
        max_per_class, max_total, True)
    assert_detections_equal(got, want, box_atol=0, score_atol=0)
    if kind == "empty":
        assert not np.asarray(want[3]).any()


@pytest.mark.parametrize("num_classes,kind,candidates", [
    (3, "random", 64), (8, "ties", 64), (4, "random", 256)])
def test_combined_nms_fast_matches_jax(rng, num_classes, kind, candidates):
    b, n = 2, 150
    boxes = _boxes(rng, (b, n))
    # Sparse scores: at most `candidates` boxes clear the threshold.
    scores = _scores(rng, (b, n, num_classes), kind)
    scores *= (rng.uniform(size=(b, n, 1)) < 0.3).astype(np.float32)
    want = jpallas.combined_nms_fast(jnp.asarray(boxes), jnp.asarray(scores),
                                     candidates=candidates, interpret=True)
    got = nms_cuda.combined_nms_fast(torch.from_numpy(boxes),
                                     torch.from_numpy(scores),
                                     candidates=candidates)
    assert_detections_equal(got, want, box_atol=0, score_atol=0)
    if kind == "random":
        # The fast path equals exact combined NMS when <= K boxes clear 0.3
        # (with tied scores the two list equal-score detections in other
        # orders, in the JAX package too).
        exact = tnms.combined_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores))
        assert_detections_equal(got, exact, box_atol=0, score_atol=0)


@pytest.mark.parametrize("n,c,iou_t,score_t,k,max_per_class,max_total", [
    (64, 3, 0.413, 0.3, 64, 100, 100),
    (96, 5, 0.5, 0.1, 64, 100, 100),
    (48, 1, 0.3, 0.05, 32, 100, 100),
    (40, 2, 0.413, 0.3, 40, 5, 8),
])
def test_combined_nms_matches_jax(rng, n, c, iou_t, score_t, k,
                                  max_per_class, max_total):
    boxes = _boxes(rng, (2, n))
    scores = _scores(rng, (2, n, c), "ties" if c > 2 else "random")
    kw = dict(iou_threshold=iou_t, score_threshold=score_t,
              max_per_class=max_per_class, max_total=max_total, pre_top_k=k)
    want = jax_combined_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw)
    got = tnms.combined_nms(torch.from_numpy(boxes),
                            torch.from_numpy(scores), **kw)
    assert got[3].dtype == torch.int32
    assert_detections_equal(got, want, box_atol=0, score_atol=0)


def test_top_k_puts_lower_index_first_on_ties():
    x = np.array([[0.5, 0.7, 0.5, 0.7, 0.1, 0.5]], np.float32)
    want_v, want_i = [np.asarray(a) for a in lax.top_k(x, 5)]
    got_v, got_i = tnms.top_k(torch.from_numpy(x), 5)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), [[1, 3, 0, 2, 5]])
