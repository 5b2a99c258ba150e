"""The port's loss (yolov4tpu_torch.losses) and train-time decode
(models.head.decode_train) against the JAX package's, on the same numpy
inputs in float32.

Tolerances: the same float32 arithmetic in the same order on both sides, up
to XLA's fusion and the libm of each side (exp, log1p, atan): rtol 1e-5 on
the elementwise functions and the loss terms; the gradient of the total
loss with respect to the raw grids (one backward through decode and the
loss, no BatchNorm) to rel-RMS 1e-5 per grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import IMG
from yolov4tpu import losses as jlosses
from yolov4tpu.config import YoloConfig
from yolov4tpu.data.encode import preprocess_true_boxes
from yolov4tpu.models import head as jhead
from yolov4tpu_torch import losses as tlosses
from yolov4tpu_torch.models import head as thead

C = 3
CFG = YoloConfig(img_size=(IMG, IMG, 3))


def _boxes_xywh(rng, n):
    xy = rng.uniform(0, IMG, (n, 2))
    wh = rng.uniform(1, IMG / 2, (n, 2))
    return np.concatenate([xy, wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["bbox_iou", "bbox_giou", "bbox_ciou"])
def test_iou_family_matches_jax(name):
    rng = np.random.default_rng(0)
    a, b = _boxes_xywh(rng, 500), _boxes_xywh(rng, 500)
    b[:50] = a[:50]                         # identical boxes
    b[50:60, 2:] = 0.0                      # degenerate (zero-area) boxes
    want = np.asarray(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tlosses, name)(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_corners_and_sigmoid_ce_match_jax():
    rng = np.random.default_rng(1)
    a = _boxes_xywh(rng, 100)
    np.testing.assert_array_equal(
        tlosses.xywh_to_x1y1x2y2(torch.from_numpy(a)).numpy(),
        np.asarray(jlosses.xywh_to_x1y1x2y2(jnp.asarray(a))))
    logits = rng.normal(0, 8, 1000).astype(np.float32)
    labels = rng.uniform(0, 1, 1000).astype(np.float32)
    np.testing.assert_allclose(
        tlosses._sigmoid_ce(torch.from_numpy(labels),
                            torch.from_numpy(logits)).numpy(),
        np.asarray(jlosses._sigmoid_ce(jnp.asarray(labels),
                                       jnp.asarray(logits))),
        rtol=1e-5, atol=1e-6)


def _scene(seed, batch=2):
    """Raw grids, GT grids and xywh boxes for one batch at IMG px."""
    rng = np.random.default_rng(seed)
    raws = [rng.normal(0, 1.5, (batch, IMG // s, IMG // s, 3 * (5 + C))
                       ).astype(np.float32) for s in CFG.strides]
    boxes = np.zeros((batch, 100, 5), np.float32)
    for b in range(batch):
        for j in range(4 + b):
            x1, y1 = rng.uniform(0, IMG * 0.7, 2)
            w, h = rng.uniform(4, IMG * 0.6, 2)
            boxes[b, j] = [x1, y1, min(x1 + w, IMG), min(y1 + h, IMG),
                           rng.integers(0, C)]
    labels, xywh = preprocess_true_boxes(boxes, (IMG, IMG),
                                         CFG.anchors_flat, C)
    return raws, labels, xywh


def test_decode_train_matches_jax():
    raws, _, _ = _scene(2)
    for i, raw in enumerate(raws):
        want = np.asarray(jax.jit(jhead.decode_train, static_argnums=(2, 3))(
            raw, CFG.anchors_grouped[i], CFG.strides[i], C))
        got = thead.decode_train(torch.from_numpy(raw),
                                 CFG.anchors_grouped[i], CFG.strides[i], C)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,smoothing,masked", [
    ("giou", 0.0, False), ("ciou", 0.0, False), ("giou", 0.1, False),
    ("giou", 0.0, True)])
def test_loss_layer_matches_jax(kind, smoothing, masked):
    raws, labels, xywh = _scene(3, batch=3)
    mask = np.array([1, 0, 1], np.float32) if masked else None
    for i, raw in enumerate(raws):
        def jlayer(raw, label, xywh, mask, i=i):
            pred = jhead.decode_train(raw, CFG.anchors_grouped[i],
                                      CFG.strides[i], C)
            return jlosses.loss_layer(raw, pred, label, xywh, CFG.strides[i],
                                      C, 0.5, kind, smoothing,
                                      sample_mask=mask)
        want = jax.jit(jlayer)(raw, labels[i], xywh, mask)
        pred_t = thead.decode_train(torch.from_numpy(raw),
                                    CFG.anchors_grouped[i], CFG.strides[i], C)
        got = tlosses.loss_layer(
            torch.from_numpy(raw), pred_t, torch.from_numpy(labels[i]),
            torch.from_numpy(xywh), CFG.strides[i], C, 0.5, kind, smoothing,
            sample_mask=None if mask is None else torch.from_numpy(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_yolo_loss_and_its_gradient_match_jax(masked):
    raws, labels, xywh = _scene(4, batch=3)
    mask = np.array([1, 1, 0], np.float32) if masked else None
    if masked:
        raws[0][2] = 60.0   # a padded sample whose exp() would overflow
    args = (CFG.anchors_grouped, CFG.strides, C, CFG.iou_loss_thresh)

    def jloss(rs):
        return jlosses.yolo_loss(
            rs, [jnp.asarray(l) for l in labels], jnp.asarray(xywh), *args,
            sample_mask=None if mask is None else jnp.asarray(mask))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(raws)
    trs = [torch.from_numpy(r).requires_grad_(True) for r in raws]
    got, comps = tlosses.yolo_loss(
        trs, [torch.from_numpy(l) for l in labels], torch.from_numpy(xywh),
        *args, return_components=True,
        sample_mask=None if mask is None else torch.from_numpy(mask))
    got.backward()
    got = got.detach()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _, want_c = jax.jit(lambda rs, ls, b, m: jlosses.yolo_loss(
        rs, ls, b, *args, return_components=True, sample_mask=m))(
            raws, labels, xywh, mask)
    for k in ("box", "conf", "prob"):
        np.testing.assert_allclose(float(comps[k].detach()), float(want_c[k]),
                                   rtol=1e-5)
    for t, w in zip(trs, want_g):
        w = np.asarray(w)
        g = t.grad.numpy()
        assert np.isfinite(g).all()
        if masked:
            assert not g[2].any()            # padded sample: zero gradient
        rms = np.sqrt(np.mean((g - w) ** 2)) / np.sqrt(np.mean(w ** 2))
        assert rms < 1e-5, rms
