"""The port's box decode (yolov4tpu_torch.models.head) and fused detection
postprocess (yolov4tpu_torch.ops.detect) against the JAX package's, on the
same raw grids.

Tolerances: sigmoid and exp may differ by an ulp between the two CPU
libraries, so decoded boxes are held to 1e-5 (normalised units) and scores
to 1e-6; classes and valid counts must be equal.  Grids whose hot cells tie
exactly (as ``weights.force_busy_heads`` makes them) check that every top-k
puts the lower index first, as ``lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import IMG, assert_detections_equal
from yolov4tpu.config import YoloConfig
from yolov4tpu.models import head as jhead
from yolov4tpu.ops.detect import detect_fused as jax_detect_fused
from yolov4tpu_torch.models import head as thead
from yolov4tpu_torch.ops import nms_cuda
from yolov4tpu_torch.ops.detect import detect_fused

CFG = YoloConfig(img_size=(IMG, IMG, 3))


def _random_raws(rng, batch, num_classes, std=2.0):
    return [rng.normal(0.0, std, (batch, g, g, 3 * (5 + num_classes)))
            .astype(np.float32) for g in CFG.grid_sizes()]


def _busy_raws(rng, batch, num_classes, hot=((2, 0, 0), (2, 1, 1), (1, 2, 2)),
               on=2.0, off=-6.0):
    """Grids as a force_busy_heads detector emits them: every hot
    (head, anchor, class) channel has the same obj and class logit at every
    cell (exact ties), everything else is off; box logits are small noise."""
    raws = []
    for h, g in enumerate(CFG.grid_sizes()):
        r = np.full((batch, g, g, 3, 5 + num_classes), off, np.float32)
        r[..., :4] = rng.normal(0.0, 0.3, (batch, g, g, 3, 4))
        for head_i, anchor, cls in hot:
            if head_i == h:
                r[..., anchor, 4] = on
                r[..., anchor, 5 + cls] = on
        raws.append(r.reshape(batch, g, g, -1))
    return raws


def _both(raws, num_classes, **kw):
    want = jax_detect_fused([jnp.asarray(r) for r in raws],
                            CFG.anchors_grouped, num_classes, CFG.strides,
                            CFG.xyscale, IMG, interpret=True, **kw)
    got = detect_fused([torch.from_numpy(r) for r in raws],
                       CFG.anchors_grouped, num_classes, CFG.strides,
                       CFG.xyscale, IMG, **kw)
    return got, want


@pytest.mark.parametrize("num_classes", [3, 8])
def test_decode_head_matches_jax(rng, num_classes):
    raws = _random_raws(rng, 2, num_classes)

    @jax.jit
    def jax_decode(raws):
        outs = jhead.decode_head(raws, CFG.anchors_grouped, num_classes,
                                 CFG.strides, CFG.xyscale)
        return outs, jhead.flatten_boxes_scores(outs, IMG, num_classes)

    want, (wb, ws) = jax_decode(raws)
    got = thead.decode_head([torch.from_numpy(r) for r in raws],
                            CFG.anchors_grouped, num_classes, CFG.strides,
                            CFG.xyscale)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        # Pixel-unit corners (up to ~400): 1e-5 relative.
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    gb, gs = thead.flatten_boxes_scores(got, IMG, num_classes)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_classes,candidates", [(3, 64), (8, 256)])
def test_detect_fused_matches_jax(rng, num_classes, candidates):
    raws = _random_raws(rng, 3, num_classes)
    got, want = _both(raws, num_classes, candidates=candidates)
    assert np.asarray(want[3]).min() > 0
    assert_detections_equal(got, want, box_atol=1e-5, score_atol=1e-6)


def test_detect_fused_low_threshold_and_small_k_matches_jax(rng):
    raws = _random_raws(rng, 2, 4)
    got, want = _both(raws, 4, iou_threshold=0.5, score_threshold=0.05,
                      max_per_class=20, max_total=20, candidates=32)
    assert_detections_equal(got, want, box_atol=1e-5, score_atol=1e-6)


@pytest.mark.parametrize("num_classes", [3, 8])
def test_detect_fused_tied_logits_matches_jax(rng, num_classes):
    raws = _busy_raws(rng, 2, num_classes)
    got, want = _both(raws, num_classes, candidates=64)
    # Every hot cell scores exactly sigmoid(2)^2: the tie order decides
    # which boxes are candidates and in what order they come out.
    scores = np.asarray(want[1])
    assert np.asarray(want[3]).min() > 1
    assert len(np.unique(scores[scores > 0])) == 1
    assert_detections_equal(got, want, box_atol=1e-5, score_atol=1e-6)


def test_detect_fused_matches_decomposed(rng):
    """The fused path equals decode_head -> flatten_boxes_scores ->
    combined_nms_fast in the port too (as tests/test_detect.py holds it in
    the JAX package)."""
    num_classes = 3
    raws = [torch.from_numpy(r) for r in _random_raws(rng, 2, num_classes)]
    outs = thead.decode_head(raws, CFG.anchors_grouped, num_classes,
                             CFG.strides, CFG.xyscale)
    boxes, scores = thead.flatten_boxes_scores(outs, IMG, num_classes)
    want = nms_cuda.combined_nms_fast(boxes, scores, candidates=64)
    got = detect_fused(raws, CFG.anchors_grouped, num_classes, CFG.strides,
                       CFG.xyscale, IMG, candidates=64)
    assert_detections_equal(got, want, box_atol=1e-5, score_atol=1e-6)
